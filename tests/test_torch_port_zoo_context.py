"""The BatchNorm families ResNet-50 and MobileNet in the port against the
JAX package on the CPU, one layer at a time (crop 64, batch 4).

A whole step of these nets at seed init is ill-conditioned: a rounding in
the forward decides a ReLU otherwise and moves gradients far below it
(``test_torch_port_zoo_conditioning.py`` measures it).  Here every layer of the
TRAIN net runs alone on the JAX forward's own blobs, so both packages see
the same inputs: outputs, BatchNorm state and the VJP (params and inputs,
seeded cotangents) hold the common tolerance (rtol 1e-4, atol 1e-5 of
each blob's largest |value|) through the residual Eltwise sums, the
BatchNorm -> Scale chains in place, and the depthwise convolutions.
"""

import pytest

pytest.importorskip("torch")

from test_torch_port_zoo import layers_in_context_match  # noqa: E402

LAYERS = {"resnet50": 228, "mobilenet": 112}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_in_context_match_jax(name):
    assert layers_in_context_match(name) == LAYERS[name]
