"""Driver apps: the reference's ``apps.*`` entry points on the port.

Counterpart of ``sparknet_tpu/apps/``.  Each reference app is a Spark
driver ``main()`` wiring loaders → preprocessing → per-worker CaffeNet →
the broadcast/train(τ)/collect loop (ref: src/main/scala/apps/).  Here each
app wires loaders → transformer → ``parallel.ParallelTrainer`` over
``torch.distributed``, one process a worker; ``FeaturizerApp`` reads a blob
of ``TPUNet.forward``, and the DB apps (``CifarDBApp``,
``ImageNetCreateDBApp``, ``ImageNetRunDBApp``) write per-worker DBs and
train a ``TPUNet`` from them.
"""

from sparknet_tpu_torch.apps.cifar_app import CifarApp  # noqa: F401
from sparknet_tpu_torch.apps.imagenet_app import ImageNetApp  # noqa: F401
from sparknet_tpu_torch.apps.db_apps import (  # noqa: F401
    CifarDBApp,
    ImageNetCreateDBApp,
    ImageNetRunDBApp,
)
from sparknet_tpu_torch.apps.featurizer import FeaturizerApp  # noqa: F401
