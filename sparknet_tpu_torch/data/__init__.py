"""Host-side data helpers: the pycaffe ``caffe.io`` image surface (``data/io_utils.py``)
and the char-text feed of the char LM (``data/text.py``)."""

from sparknet_tpu_torch.data.text import CharVocab, char_lm_batches, load_corpus  # noqa: F401
