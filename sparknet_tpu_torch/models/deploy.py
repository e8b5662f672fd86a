"""Deploy-time inference wrapper for the Classifier.

Counterpart of ``sparknet_tpu/models/deploy.py`` (ref:
caffe/python/caffe/classifier.py:11-99, pycaffe.py:155-197
``_Net_forward_all``).  The handle owns a TEST-phase ``Network`` on one
device and runs any number of inputs in net-batch-size chunks, padding the
ragged tail and trimming it from the outputs.  ``fold_batchnorm`` is the
``merge_bn`` deploy flow (``models/fold_bn.py``).  ``pretrained_file`` is a
``.caffemodel`` (params and BatchNorm state, by layer name); HDF5 weights
are ROADMAP Queue A4.  Without a file the weights come from
``Network.init``, or from the JAX package through ``interop.py``.
``quantize_int8`` switches the forward to the post-training int8 path
(``quant.py``); fold first, then quantize.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from sparknet_tpu_torch.common import Phase
from sparknet_tpu_torch.compiler.graph import Network, NetVars
from sparknet_tpu_torch.data import io_utils as cio
from sparknet_tpu_torch.proto.text_format import Message


class DeployNet:
    """TEST-phase net + Transformer, loaded from a prototxt.

    ``model_file`` is a deploy prototxt path or an already-parsed
    ``NetParameter`` Message; ``pretrained_file`` a ``.caffemodel``.
    ``device=None`` means CUDA and raises without a CUDA device; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        model_file: str | Message,
        pretrained_file: str | None = None,
        mean: np.ndarray | None = None,
        input_scale: float | None = None,
        raw_scale: float | None = None,
        channel_swap: tuple[int, ...] | None = None,
        device: str | torch.device | None = None,
    ):
        if pretrained_file is not None and pretrained_file.endswith(
                (".h5", ".hdf5", ".caffemodel.h5")):
            raise NotImplementedError(
                f"{pretrained_file}: HDF5 weights need h5py, which the card's "
                "machine lacks (ROADMAP Queue A4); use a .caffemodel")
        if isinstance(model_file, Message):
            net_param = model_file
        else:
            from sparknet_tpu_torch.proto_loader import load_net_prototxt

            net_param = load_net_prototxt(model_file)
        self.network = Network(net_param, Phase.TEST, device=device)
        self.device = self.network.device
        self.variables = self.network.init()
        # the int8 quant state (quantize_int8), and its records with their
        # weight matrices made once for the forward (quant.prepare)
        self.qstate: dict | None = None
        self._qrun: dict | None = None
        if pretrained_file is not None:
            from sparknet_tpu_torch.net import copy_caffemodel_params

            params, state, _ = copy_caffemodel_params(
                self.variables.params, pretrained_file, state=self.variables.state)
            self.variables = NetVars(params=params, state=state)

        shapes = self.network.feed_shapes()
        # data inputs only — a deploy net has no label feed, but a net built
        # from a train prototxt may; keep 4-D image feeds
        self.inputs = [n for n, s in shapes.items() if len(s) == 4] or list(shapes)
        self.outputs = self.network.output_blobs()
        self.feed_shapes = shapes

        in_ = self.inputs[0]
        self.transformer = cio.Transformer({in_: shapes[in_]})
        self.transformer.set_transpose(in_, (2, 0, 1))
        if mean is not None:
            self.transformer.set_mean(in_, np.asarray(mean, np.float32))
        if input_scale is not None:
            self.transformer.set_input_scale(in_, input_scale)
        if raw_scale is not None:
            self.transformer.set_raw_scale(in_, raw_scale)
        if channel_swap is not None:
            self.transformer.set_channel_swap(in_, channel_swap)

    def fold_batchnorm(self) -> list[str]:
        """Fold in-place BatchNorm(+Scale) chains into their producing
        Conv/InnerProduct weights (the Caffe-ecosystem ``merge_bn`` deploy
        flow, ``models/fold_bn.py``): the forward loses two elementwise
        passes a chain.  Returns the folded-chain labels; inference-only,
        since the statistics are baked in."""
        from sparknet_tpu_torch.models.fold_bn import fold_batchnorm

        if self.qstate is not None:
            # folding rebuilds the float forward; after int8 calibration it
            # would drop the quantized path while qstate still claims it
            raise RuntimeError(
                "fold_batchnorm() must run BEFORE quantize_int8 — the "
                "fold rebuilds the network and the calibrated scales "
                "would no longer match it")
        net2, params2, state2, folded = fold_batchnorm(
            self.network.net_param, self.variables.params, self.variables.state)
        if folded:
            self.network = Network(net2, Phase.TEST, device=self.device)
            self.variables = NetVars(params=params2, state=state2)
        return folded

    def quantize_int8(self, calibration_batches, num_batches: int = 4) -> dict:
        """Switch this deploy net's forward to the post-training int8 path
        (``quant.py``): per-channel int8 weights and calibrated per-tensor
        int8 activations, int32 sums.  ``calibration_batches``: an iterable
        of feed dicts shaped like the forward's own (``{input_name: (B, C,
        H, W)}``).  Returns the quant state; later ``predict``/
        ``forward_all`` calls run quantized.  Inference only."""
        from sparknet_tpu_torch import quant

        self.qstate = quant.calibrate(self.network, self.variables,
                                      calibration_batches, num_batches=num_batches)
        self._qrun = quant.prepare(self.qstate, self.network)
        return self.qstate

    def forward_all(self, in_: str, data: np.ndarray) -> dict[str, np.ndarray]:
        """Forward N preprocessed samples in net-batch chunks; concat outputs.

        ref: pycaffe.py:155-197 — batch, forward, drop padding.
        """
        batch = self.feed_shapes[in_][0]
        n = len(data)
        outs: dict[str, list[np.ndarray]] = {o: [] for o in self.outputs}
        from sparknet_tpu_torch import quant

        qctx = (quant.quantized_inference(self._qrun) if self._qrun is not None
                else contextlib.nullcontext())
        with torch.inference_mode(), qctx:
            for lo in range(0, n, batch):
                chunk = np.asarray(data[lo : lo + batch], np.float32)
                if len(chunk) < batch:  # pad the ragged tail; trimmed below
                    pad = np.zeros((batch - len(chunk),) + chunk.shape[1:], chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                blobs = self.network.apply(self.variables, {in_: chunk}, train=False)[0]
                for o in self.outputs:
                    outs[o].append(blobs[o].cpu().numpy())
        return {o: np.concatenate(v)[:n] for o, v in outs.items()}
