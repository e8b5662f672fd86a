"""sparknet_tpu_torch — the PyTorch/CUDA port of ``sparknet_tpu``.

A second package beside the JAX one, with the same file layout and names so
each module's counterpart is easy to find.  It imports ``torch`` and numpy
and nothing of ``sparknet_tpu`` (importing that package loads jax); the
host-only modules it needs are its own copies.

This first slice is the TEST-phase serving path: prototxt nets (LeNet,
CIFAR-10 quick/full, AlexNet, CaffeNet) compiled by ``compiler.graph.
Network`` and served through ``models.Classifier``, with cross-channel LRN
as a hand-written CUDA kernel (``csrc/lrn.cu``, bound in ``ops/kernels.py``).
Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from sparknet_tpu_torch.common import Phase, get_config, resolve_device  # noqa: F401
