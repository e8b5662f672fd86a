"""Model zoo builders, cached decode builders, sampling and deploy-time inference.

Each builder returns a ``NetParameter`` Message ready for ``Network``
(ref: caffe/models/ + caffe/examples/), each ``*_solver()`` the
``SolverConfig`` of its published solver.prototxt; ``Classifier`` and
``Detector`` are pycaffe's deploy-time classifier and R-CNN window detector
on a torch device; ``generate_chars`` samples from a trained char LM.
"""

from sparknet_tpu_torch.models.classifier import Classifier  # noqa: F401
from sparknet_tpu_torch.models.deploy import DeployNet  # noqa: F401
from sparknet_tpu_torch.models.detector import Detector  # noqa: F401
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
    googlenet,
    googlenet_solver,
    lenet,
    lenet_solver,
    mnist_autoencoder,
    mnist_autoencoder_solver,
    mnist_siamese,
    mnist_siamese_solver,
    mobilenet,
    mobilenet_solver,
    resnet50,
    resnet50_solver,
    squeezenet,
    squeezenet_solver,
    transformer,
    transformer_solver,
    vgg16,
    vgg16_solver,
)

# Per-family input crop for the ImageNet benchmark families: the train_val
# crops (AlexNet/CaffeNet 227; GoogLeNet/MobileNet/ResNet/VGG 224;
# SqueezeNet v1.1's published crop is 227).
BENCH_CROPS = {
    "alexnet": 227, "caffenet": 227, "googlenet": 224, "mobilenet": 224,
    "resnet50": 224, "vgg16": 224, "squeezenet": 227,
}
