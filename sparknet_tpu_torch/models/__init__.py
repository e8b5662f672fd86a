"""Model zoo builders, cached decode builders, sampling and deploy-time inference.

Each builder returns a ``NetParameter`` Message ready for ``Network``
(ref: caffe/models/ + caffe/examples/), each ``*_solver()`` the
``SolverConfig`` of its published solver.prototxt; ``Classifier`` is pycaffe's
deploy-time classifier on a torch device; ``generate_chars`` samples from a
trained char LM.
"""

from sparknet_tpu_torch.models.classifier import Classifier  # noqa: F401
from sparknet_tpu_torch.models.deploy import DeployNet  # noqa: F401
from sparknet_tpu_torch.models.generate import generate_chars  # noqa: F401
from sparknet_tpu_torch.models.zoo import (  # noqa: F401
    GRAPH_SWEEP_FAMILIES,
    DecodeSpec,
    GraphFamily,
    alexnet,
    alexnet_solver,
    build_decode_step,
    build_prefill,
    caffenet,
    caffenet_solver,
    charlm,
    charlm_solver,
    cifar10_full,
    cifar10_full_solver,
    cifar10_quick,
    cifar10_quick_solver,
    decode_spec,
    lenet,
    lenet_solver,
    transformer,
    transformer_solver,
)
