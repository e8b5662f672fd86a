"""Deploy-time BatchNorm folding — the Caffe-ecosystem ``merge_bn`` flow.

Counterpart of ``sparknet_tpu/models/fold_bn.py``.  The 2015-era zoo
shipped BN nets (ResNet) as Conv → BatchNorm → Scale triples, and the
standard deploy optimization folded the two affine layers into the
convolution's own weights (community `merge_bn.py` tools alongside the
published prototxts; same algebra as modern inference-graph BN folding).
At inference the BN statistics are constants, so the fold deletes two
elementwise passes over every activation map from the forward, and it
reduces the net to pure Conv/IP layers.  The algebra runs in float64 on
the host (numpy) and each blob returns to its own type and device.

Algebra, per output channel c (Caffe BN stores *accumulated* sums with
a scale factor — ref: caffe/src/caffe/layers/batch_norm_layer.cpp:75
Forward_cpu):

    mean  = mean_acc / sf          var = var_acc / sf
    d     = sqrt(var + eps)
    W'[c] = W[c] * gamma[c] / d[c]
    b'[c] = (b[c] - mean[c]) * gamma[c] / d[c] + beta[c]

Only canonical in-place chains fold — Conv/InnerProduct producing blob
B, then BatchNorm in-place on B, optionally followed by Scale in-place
on B with a per-channel (C,) gamma.  Anything else (bottom-supplied
scale, axis != 1, non-in-place wiring) is left untouched: the fold is
an optimization, not a requirement.  Producers whose weights are
SHARED across layers (``param { name: ... }`` declared by more than
one layer — siamese towers, ref: net.cpp:470+ AppendParam) are also
skipped: baking one branch's BN statistics into a shared blob would
silently change every other reader's output.
"""

from __future__ import annotations

import numpy as np
import torch

from sparknet_tpu_torch.proto.text_format import Message

_FOLDABLE_PRODUCERS = ("Convolution", "InnerProduct")


def _tops(lp: Message) -> list[str]:
    return [str(t) for t in lp.get_all("top")]


def _bottoms(lp: Message) -> list[str]:
    return [str(b) for b in lp.get_all("bottom")]


def _np(blob) -> np.ndarray:
    """A blob (a tensor on any device, or an array) as a host array."""
    if isinstance(blob, torch.Tensor):
        return blob.detach().to("cpu", torch.float64).numpy()
    return np.asarray(blob)


def _like(value: np.ndarray, blob):
    """``value`` in ``blob``'s type, on its device when it is a tensor."""
    if isinstance(blob, torch.Tensor):
        return torch.from_numpy(value).to(device=blob.device, dtype=blob.dtype)
    return value.astype(np.asarray(blob).dtype)


def _bn_stats(state: dict, eps: float) -> tuple[np.ndarray, np.ndarray]:
    """(mean, 1/sqrt(var+eps)) from the layer's accumulated state."""
    sf = float(_np(state["scale_factor"]).ravel()[0])
    factor = 1.0 if sf == 0.0 else 1.0 / max(sf, 1e-30)
    mean = _np(state["mean"]).astype(np.float64) * factor
    var = _np(state["variance"]).astype(np.float64) * factor
    return mean, 1.0 / np.sqrt(np.maximum(var, 0.0) + eps)


def fold_batchnorm(net_param: Message, params: dict, state: dict
                   ) -> tuple[Message, dict, dict, list[str]]:
    """Fold in-place BN(+Scale) chains into their producing Conv/IP.

    Returns ``(net_param', params', state', folded_layer_names)`` — the
    new net has the BN/Scale layers removed and the producers' weights
    rewritten (``bias_term`` forced on, since the fold always creates a
    bias).  Inference-only: the folded net scores identically to the
    original's TEST phase (pinned in tests/test_fold_bn.py) but cannot
    continue training (the statistics are baked in).
    """
    layers = net_param.get_all("layer")
    new_params = {k: list(v) for k, v in params.items()}
    new_state = dict(state)
    drop: set[int] = set()
    folded: list[str] = []

    # param names declared by MORE THAN ONE layer = shared blobs
    # (net.cpp AppendParam): a producer carrying one must not be folded
    counts: dict[str, int] = {}
    for l in layers:
        for pm in l.get_all("param"):
            n = pm.get_str("name", "")
            if n:
                counts[n] = counts.get(n, 0) + 1
    shared_names = {n for n, c in counts.items() if c > 1}

    i = 0
    while i < len(layers):
        lp = layers[i]
        if lp.get_str("type") != "BatchNorm":
            i += 1
            continue
        bots, tops = _bottoms(lp), _tops(lp)
        if not (len(bots) == 1 and tops == bots):
            i += 1
            continue  # not in-place: leave untouched
        if not lp.get_msg("batch_norm_param").get_bool(
                "use_global_stats", True):
            # an explicit use_global_stats:false computes PER-BATCH
            # statistics even at TEST time (ops/blocks.py apply) —
            # baking the accumulated stats would change its scores
            i += 1
            continue
        blob = bots[0]
        # the producer must be the LAST writer of the blob before this
        # BN — with in-place chains that is simply the nearest earlier
        # layer listing it as a top
        prod_idx = max((j for j, l in enumerate(layers[:i])
                        if blob in _tops(l)), default=-1)
        if prod_idx < 0:
            i += 1
            continue
        prod = layers[prod_idx]
        if prod.get_str("type") not in _FOLDABLE_PRODUCERS:
            i += 1
            continue

        def _has_shared(l: Message) -> bool:
            return any(pm.get_str("name", "") in shared_names
                       for pm in l.get_all("param"))
        if any(blob in _bottoms(l) for l in layers[prod_idx + 1:i]):
            # an intermediate layer reads the RAW pre-BN activation
            # (execution order = layer order for in-place chains);
            # folding would silently hand it normalized values — skip
            i += 1
            continue
        bn_name = lp.get_str("name")
        if bn_name not in new_state or "scale_factor" not in new_state[bn_name]:
            i += 1
            continue  # state not materialized (fresh net): nothing to bake
        eps = lp.get_msg("batch_norm_param").get_float("eps", 1e-5)
        mean, inv_std = _bn_stats(new_state[bn_name], eps)

        gamma = np.ones_like(mean)
        beta = np.zeros_like(mean)
        scale_idx = None
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if (nxt is not None and nxt.get_str("type") == "Scale"
                and _bottoms(nxt) == [blob] and _tops(nxt) == [blob]):
            sp = nxt.get_msg("scale_param")
            s_params = new_params.get(nxt.get_str("name"), [])
            if (sp.get_int("axis", 1) == 1 and sp.get_int("num_axes", 1) == 1
                    and s_params and _np(s_params[0]).shape == mean.shape):
                gamma = _np(s_params[0]).astype(np.float64)
                if len(s_params) > 1:
                    beta = _np(s_params[1]).astype(np.float64)
                scale_idx = i + 1

        if (_has_shared(prod) or _has_shared(lp)
                or (scale_idx is not None
                    and _has_shared(layers[scale_idx]))):
            # shared blobs (param{} aliasing, siamese towers): rewriting
            # the producer would bake THIS branch's BN stats into
            # weights another layer reads, and DROPPING a BN/Scale that
            # owns a shared blob would orphan its aliases' 0-size
            # placeholders — skip the whole chain
            i += 1
            continue

        pname = prod.get_str("name")
        blobs = new_params[pname]
        w = _np(blobs[0]).astype(np.float64)
        if w.shape[0] != mean.shape[0]:
            i += 1
            continue  # channel mismatch (grouped/custom wiring): skip
        g = gamma * inv_std
        new_w = w * g.reshape((-1,) + (1,) * (w.ndim - 1))
        b = (_np(blobs[1]).astype(np.float64) if len(blobs) > 1
             else np.zeros_like(mean))
        new_b = (b - mean) * g + beta

        # rewrite the producer: weights + a forced bias_term
        prod2 = prod.copy()
        pp_key = ("convolution_param" if prod.get_str("type") == "Convolution"
                  else "inner_product_param")
        pp = prod2.get_msg(pp_key).copy()
        pp.set("bias_term", True)
        prod2.set(pp_key, pp)
        layers[prod_idx] = prod2
        new_params[pname] = [_like(new_w, blobs[0]), _like(new_b, blobs[0])]

        drop.add(i)
        new_state.pop(bn_name, None)
        new_params.pop(bn_name, None)
        if scale_idx is not None:
            drop.add(scale_idx)
            new_params.pop(layers[scale_idx].get_str("name"), None)
            folded.append(f"{pname} <- {bn_name} + "
                          f"{layers[scale_idx].get_str('name')}")
            i = scale_idx + 1
        else:
            folded.append(f"{pname} <- {bn_name}")
            i += 1

    out = Message()
    for field, values in net_param.fields.items():
        if field == "layer":
            continue
        for v in values:
            out.add(field, v)
    for j, lp in enumerate(layers):
        if j not in drop:
            out.add("layer", lp)
    return out, new_params, new_state, folded
