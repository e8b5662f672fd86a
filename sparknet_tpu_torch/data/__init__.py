"""Host-side data helpers: the pycaffe ``caffe.io`` image surface (``data/io_utils.py``)."""
