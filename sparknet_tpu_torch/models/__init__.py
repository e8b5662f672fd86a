"""Model zoo CNN builders and deploy-time inference.

Each builder returns a ``NetParameter`` Message ready for ``Network``
(ref: caffe/models/ + caffe/examples/); ``Classifier`` is pycaffe's
deploy-time classifier on a torch device.
"""

from sparknet_tpu_torch.models.classifier import Classifier  # noqa: F401
from sparknet_tpu_torch.models.deploy import DeployNet  # noqa: F401
from sparknet_tpu_torch.models.zoo import (  # noqa: F401
    alexnet,
    caffenet,
    cifar10_full,
    cifar10_quick,
    lenet,
)
