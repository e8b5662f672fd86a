"""NetParameter -> executable torch network (``compiler/graph.py``)."""
