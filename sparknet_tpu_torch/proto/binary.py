"""``.caffemodel`` binary IO: a proto2 wire codec with no protobuf library.

Copy of ``sparknet_tpu/proto/binary.py``.  The reference snapshots models
as binary-protobuf ``NetParameter`` files (ref: caffe/src/caffe/net.cpp:911
Net::ToProto + solver.cpp:447-519 Snapshot; libccaffe save_weights_to_file
ccaffe.cpp:261-273).  This module speaks the proto2 wire format directly
for the blob-carrying subset of the schema (field numbers from caffe.proto:
NetParameter.name=1, .layer=100, .layers=2 (V1); LayerParameter.name=1,
.type=2, .blobs=7; V1LayerParameter.name=4, .type=5 (enum), .blobs=6;
BlobProto.shape=7, .data=5, .double_data=8, legacy num/channels/height/
width=1-4; BlobShape.dim=1 packed).  The same wire helpers serve the
``Datum`` and ``BlobProto`` codecs of ``data/io_utils.py``.

Decoding takes ``bytes`` or any buffer (a ``memoryview`` over a writable
``bytearray`` included): ``load_caffemodel`` reads the file into one
``bytearray`` and every blob is an ndarray view of it, so a model's
weights are held once on the host while they load.

Load maps by layer name with Caffe's CopyTrainedLayersFrom semantics
(``net.copy_caffemodel_params``; ref: net.cpp:737-805).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


# ---------------------------------------------------------------- reading
def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint overrun")


def _scan(buf):
    """Yield (field_number, wire_type, payload) over one message's bytes.
    payload: int for varint/fixed, bytes for length-delimited."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _I64:
            val = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wt == _LEN:
            n, pos = _read_varint(buf, pos)
            val = buf[pos : pos + n]
            pos += n
        elif wt == _I32:
            val = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, val


def _packed_varints(payload) -> list[int]:
    out, pos = [], 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        out.append(v)
    return out


def _decode_blob(buf) -> np.ndarray:
    shape: list[int] = []
    legacy = [0, 0, 0, 0]  # num, channels, height, width
    # proto2 readers must accept a packed repeated field split over several
    # chunks AND mixed packed/unpacked encodings — accumulate, never assign.
    chunks: list[np.ndarray] = []
    for field, wt, val in _scan(buf):
        if field == 7 and wt == _LEN:  # BlobShape
            for f2, w2, v2 in _scan(val):
                if f2 == 1:
                    if w2 == _LEN:
                        shape.extend(_packed_varints(v2))
                    else:
                        shape.append(v2)
        elif field == 5:  # float data
            if wt == _LEN:
                chunks.append(np.frombuffer(val, "<f4"))
            else:  # unpacked element arrives as I32 bits
                chunks.append(
                    np.frombuffer(struct.pack("<i", val), "<f4")
                )
        elif field == 8 and wt == _LEN:  # double data
            chunks.append(np.frombuffer(val, "<f8").astype(np.float32))
        elif field in (1, 2, 3, 4) and wt == _VARINT:
            legacy[field - 1] = val
    if len(chunks) == 1:
        data = chunks[0]  # one packed chunk: a view of the buffer
    else:
        data = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    data = data.astype(np.float32, copy=False)
    if not shape and any(legacy):
        shape = [d for d in legacy]
    if shape:
        data = data.reshape(shape)
    return data


_V1_TYPE_NAMES = {
    # V1LayerParameter.LayerType enum, verbatim from the reference schema
    # (ref: caffe.proto "enum LayerType" inside V1LayerParameter), mapped
    # to the V2 type strings (UpgradeV1LayerType).
    1: "Accuracy", 2: "BNLL", 3: "Concat", 4: "Convolution", 5: "Data",
    6: "Dropout", 7: "EuclideanLoss", 8: "Flatten", 9: "HDF5Data",
    10: "HDF5Output", 11: "Im2col", 12: "ImageData", 13: "InfogainLoss",
    14: "InnerProduct", 15: "LRN", 16: "MultinomialLogisticLoss",
    17: "Pooling", 18: "ReLU", 19: "Sigmoid", 20: "Softmax",
    21: "SoftmaxWithLoss", 22: "Split", 23: "TanH", 24: "WindowData",
    25: "Eltwise", 26: "Power", 27: "SigmoidCrossEntropyLoss",
    28: "HingeLoss", 29: "MemoryData", 30: "ArgMax", 31: "Threshold",
    32: "DummyData", 33: "Slice", 34: "MVN", 35: "AbsVal", 36: "Silence",
    37: "ContrastiveLoss", 38: "Exp", 39: "Deconvolution",
}


@dataclasses.dataclass
class CaffeModelLayer:
    name: str
    type: str
    blobs: list[np.ndarray]


@dataclasses.dataclass
class CaffeModel:
    name: str
    layers: list[CaffeModelLayer]

    def by_name(self) -> dict[str, CaffeModelLayer]:
        return {l.name: l for l in self.layers}


def _text(val) -> str:
    return bytes(val).decode("utf-8", "replace")


def _decode_layer(buf, v1: bool) -> CaffeModelLayer:
    name = ""
    type_ = ""
    blobs: list[np.ndarray] = []
    name_field = 4 if v1 else 1
    blob_field = 6 if v1 else 7
    for field, wt, val in _scan(buf):
        if field == name_field and wt == _LEN:
            name = _text(val)
        elif not v1 and field == 2 and wt == _LEN:
            type_ = _text(val)
        elif v1 and field == 5 and wt == _VARINT:
            type_ = _V1_TYPE_NAMES.get(val, f"V1:{val}")
        elif field == blob_field and wt == _LEN:
            blobs.append(_decode_blob(val))
    return CaffeModelLayer(name, type_, blobs)


def loads_caffemodel(buf) -> CaffeModel:
    """Decode a serialized NetParameter (``bytes`` or a buffer; blobs are
    views of a ``memoryview``'s memory)."""
    name = ""
    layers: list[CaffeModelLayer] = []
    for field, wt, val in _scan(buf):
        if field == 1 and wt == _LEN:
            name = _text(val)
        elif field == 100 and wt == _LEN:
            layers.append(_decode_layer(val, v1=False))
        elif field == 2 and wt == _LEN:
            layers.append(_decode_layer(val, v1=True))
    return CaffeModel(name, layers)


def load_caffemodel(path: str) -> CaffeModel:
    """Read ``path`` into one writable buffer and decode it: each blob is
    a float32 view of that buffer (no second host copy of the weights)."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        n = f.readinto(buf)
    if n != len(buf):
        raise OSError(f"{path}: read {n} of {len(buf)} bytes")
    return loads_caffemodel(memoryview(buf))


# ---------------------------------------------------------------- writing
def _varint(v: int) -> bytes:
    if v < 0:
        # proto2 negative int32/int64 varints are the two's-complement
        # 64-bit value (10 bytes on the wire)
        v &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(payload)) + payload


def _encode_blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    dims = b"".join(_varint(int(d)) for d in arr.shape)
    shape_msg = _len_field(1, dims)  # BlobShape.dim packed
    out = _len_field(7, shape_msg)
    out += _len_field(5, arr.astype("<f4").tobytes())  # packed float data
    return out


def _encode_layer(layer: CaffeModelLayer) -> bytes:
    out = _len_field(1, layer.name.encode())
    out += _len_field(2, layer.type.encode())
    for b in layer.blobs:
        out += _len_field(7, _encode_blob(b))
    return out


def _records(model: CaffeModel):
    """The serialized NetParameter in pieces: its name field, then each
    layer's tag and length and its payload."""
    yield _len_field(1, model.name.encode())
    for layer in model.layers:
        payload = _encode_layer(layer)
        yield _tag(100, _LEN) + _varint(len(payload))
        yield payload


def dumps_caffemodel(model: CaffeModel) -> bytes:
    return b"".join(_records(model))


def save_caffemodel(path: str, model: CaffeModel) -> None:
    """Write ``model`` one layer record at a time (the bytes of
    ``dumps_caffemodel``)."""
    with open(path, "wb") as f:
        for piece in _records(model):
            f.write(piece)


# ---------------------------------------------------------------------------
# Binary V1 -> V2 NetParameter upgrade (ref: tools/upgrade_net_proto_binary
# + UpgradeV1LayerParameter): field-number remapping over the raw wire, so
# every layer field — connectivity, include/exclude rules, typed params,
# loss weights, blobs — survives byte-identically.
# ---------------------------------------------------------------------------

# V1LayerParameter field -> LayerParameter field for fields whose payload
# is wire-compatible (same sub-message type or same scalar type).
_V1_TO_V2_FIELDS = {
    2: 3,    # bottom
    3: 4,    # top
    4: 1,    # name
    32: 8,   # include
    33: 9,   # exclude
    6: 7,    # blobs
    35: 5,   # loss_weight
    36: 100,  # transform_param
    42: 101,  # loss_param
    27: 102,  # accuracy_param
    23: 103,  # argmax_param
    9: 104,   # concat_param
    40: 105,  # contrastive_loss_param
    10: 106,  # convolution_param
    11: 107,  # data_param
    12: 108,  # dropout_param
    26: 109,  # dummy_data_param
    24: 110,  # eltwise_param
    41: 111,  # exp_param
    13: 112,  # hdf5_data_param
    14: 113,  # hdf5_output_param
    29: 114,  # hinge_loss_param
    15: 115,  # image_data_param
    16: 116,  # infogain_loss_param
    17: 117,  # inner_product_param
    18: 118,  # lrn_param
    22: 119,  # memory_data_param
    34: 120,  # mvn_param
    19: 121,  # pooling_param
    21: 122,  # power_param
    30: 123,  # relu_param
    38: 124,  # sigmoid_param
    39: 125,  # softmax_param
    31: 126,  # slice_param
    37: 127,  # tanh_param
    25: 128,  # threshold_param
    20: 129,  # window_data_param
}


def _emit(field: int, wt: int, val) -> bytes:
    if wt == _LEN:
        return _len_field(field, val)
    if wt == _VARINT:
        return _tag(field, _VARINT) + _varint(val)
    if wt == _I32:
        return _tag(field, _I32) + struct.pack("<i", val)
    return _tag(field, _I64) + struct.pack("<q", val)


def upgrade_v1_layer_record(rec: bytes) -> bytes:
    """One serialized V1LayerParameter -> serialized LayerParameter.

    The enum ``type`` becomes the V2 string; repeated ``param`` (share
    names) / ``blobs_lr`` / ``weight_decay`` fold into ParamSpec messages
    (name=1, lr_mult=3, decay_mult=4); everything else remaps field
    numbers with the payload untouched."""
    parts: list[bytes] = []
    names: list[bytes] = []
    lrs: list[int] = []      # raw fixed32 bit patterns
    decays: list[int] = []
    share_modes: list[int] = []
    for field, wt, val in _scan(rec):
        if field == 5 and wt == _VARINT:  # type enum -> string
            tname = _V1_TYPE_NAMES.get(val)
            if tname is None:
                raise ValueError(f"unknown V1 LayerType enum value {val}")
            parts.append(_len_field(2, tname.encode()))
        elif field == 1001 and wt == _LEN:  # param share name
            names.append(val)
        elif field in (7, 8):  # blobs_lr / weight_decay (repeated float,
            # possibly packed): collect raw fixed32 bit patterns
            dst = lrs if field == 7 else decays
            if wt == _LEN:
                for off in range(0, len(val), 4):
                    dst.append(struct.unpack_from("<i", val, off)[0])
            else:
                dst.append(val)
        elif field == 1 and wt == _LEN:
            raise ValueError(
                "nested V0LayerParameter found — upgrade the model through "
                "the text path (upgrade_net_proto_text) first"
            )
        elif field == 1002:  # blob_share_mode -> ParamSpec.share_mode
            if wt == _LEN:
                share_modes.extend(_packed_varints(val))
            else:
                share_modes.append(val)
        else:
            v2 = _V1_TO_V2_FIELDS.get(field)
            if v2 is not None:
                parts.append(_emit(v2, wt, val))
            # unknown/unmapped fields are dropped (the reference's protobuf
            # would keep them as unknown fields; none exist in the schema)
    n = max(len(names), len(lrs), len(decays), len(share_modes))
    for i in range(n):
        pm: list[bytes] = []
        if i < len(names) and names[i]:
            pm.append(_len_field(1, names[i]))
        if i < len(share_modes):
            pm.append(_tag(2, _VARINT) + _varint(share_modes[i]))
        if i < len(lrs):
            pm.append(_tag(3, _I32) + struct.pack("<i", lrs[i]))
        if i < len(decays):
            pm.append(_tag(4, _I32) + struct.pack("<i", decays[i]))
        parts.append(_len_field(6, b"".join(pm)))
    return b"".join(parts)


def upgrade_net_binary(buf: bytes) -> tuple[bytes, int]:
    """Serialized NetParameter with V1 ``layers`` (field 2) -> current
    schema (``layer`` field 100).  Net-level fields pass through.
    Returns (upgraded bytes, number of upgraded V1 records)."""
    parts: list[bytes] = []
    upgraded = 0
    for field, wt, val in _scan(buf):
        if field == 2 and wt == _LEN:
            parts.append(_len_field(100, upgrade_v1_layer_record(val)))
            upgraded += 1
        else:
            parts.append(_emit(field, wt, val))
    return b"".join(parts), upgraded
