"""Host data plane and feed: loaders, augmentation, minibatching, the
process ring, the device prefetcher and on-card augmentation.

Counterpart of ``sparknet_tpu/data/``.  The host-only modules (the LMDB
codec, the Datum and image helpers, the CIFAR and tar loaders, the
transformer, the samplers, the ring and its record sources) are copies
that import no torch, so the ring's worker processes make no CUDA call;
so are ``createdb`` (the record/LMDB/LevelDB writers and readers),
``leveldb_io``, ``listfile`` (the host streams of the Data, ImageData and
WindowData layers), ``resize_images``, ``digits`` and ``remote`` (local
shard stores).
The card side: ``prefetch.DevicePrefetcher`` (pinned staging, a copy
stream and events), ``pipeline.device_feed`` and
``device_transform.DeviceAugment``.  The char-text feed of the char LM is
``data/text.py``.
"""

from sparknet_tpu_torch.data.cifar import CifarLoader  # noqa: F401
from sparknet_tpu_torch.data.sampler import MinibatchSampler  # noqa: F401
from sparknet_tpu_torch.data.device_transform import DeviceAugment  # noqa: F401
from sparknet_tpu_torch.data.transform import DataTransformer, TransformConfig  # noqa: F401
from sparknet_tpu_torch.data.minibatch import (  # noqa: F401
    compute_mean,
    compute_mean_from_minibatches,
    make_minibatches,
    make_minibatches_compressed,
)
from sparknet_tpu_torch.data.archive import ImageNetLoader, list_archive_samples  # noqa: F401
from sparknet_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: F401
from sparknet_tpu_torch.data.pipeline import (  # noqa: F401
    ArraySource,
    BatchSource,
    DataFnSource,
    FeedSpec,
    PrestagedSource,
    ProcessPipeline,
    SyntheticImageSource,
    TransformStage,
    device_feed,
)
from sparknet_tpu_torch.data.records import RecordShardSource  # noqa: F401
from sparknet_tpu_torch.data.text import CharVocab, char_lm_batches, load_corpus  # noqa: F401
