"""Solvers: learning-rate policies, the six Caffe update rules, the flat
arenas of the fused update, and the ``Solver`` that trains a net."""
