"""Feature extraction app.

Counterpart of ``sparknet_tpu/apps/featurizer.py`` (ref:
src/main/scala/apps/FeaturizerApp.scala:14-107): set the weights once,
``forward()`` each minibatch, read an intermediate blob ("ip1") from
``getData``.  ``TPUNet.forward`` runs the TEST-phase graph on the net's
device and returns every blob; the feature comes back to the host as
numpy.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from sparknet_tpu_torch.net import TPUNet, WeightCollection


class FeaturizerApp:
    """``net`` is a port ``TPUNet`` (built with ``device=None``, CUDA, or
    ``device="cpu"``)."""

    def __init__(self, net: TPUNet, feature_blob: str = "ip1"):
        self.net = net
        self.feature_blob = feature_blob

    def set_weights(self, wc: WeightCollection) -> None:
        self.net.set_weights(wc)

    def featurize(
        self, minibatches: Iterable[dict[str, np.ndarray]]
    ) -> Iterator[np.ndarray]:
        """Yield the feature blob of each minibatch (ref:
        FeaturizerApp.scala:88-102 forward + getData); a blob the net
        lacks raises ``KeyError`` naming the blobs it has."""
        for feeds in minibatches:
            blobs = self.net.forward(feeds)
            if self.feature_blob not in blobs:
                raise KeyError(
                    f"blob {self.feature_blob!r} not in net; have "
                    f"{sorted(blobs)}"
                )
            yield blobs[self.feature_blob].cpu().numpy()
