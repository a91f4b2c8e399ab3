"""Communication optimizer (paper §III-D): degree-aware quantization (DAQ)
plus lossless sparsity elimination.

DAQ: vertices are binned by degree into four intervals <D1, D2, D3> and
their feature vectors linearly quantized to <q0, q1, q2, q3> bits
(default <64, 32, 16, 8>): high-degree vertices tolerate aggressive
quantization because aggregation smooths their error. Thm 2's closed-form
compression ratio is implemented and tested against measured bits.

Lossless stage: the paper uses LZ4 + bit shuffling. When the optional
``lz4`` package is importable, the ``"lz4"`` codec (and the ``daq_lz4``
COMPRESSORS entry) uses real LZ4 frames after the byte-shuffle filter;
otherwise requesting it falls back to the stdlib zlib codec with a
warning. The default stays zlib so wire-byte accounting is stable across
environments. The shuffle transposes the byte planes of fixed-width
elements, which groups the mostly-zero high bytes of sparse/quantized
features and greatly improves either entropy coder's ratio.
"""
from __future__ import annotations

import dataclasses
import warnings
import zlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

try:
    import lz4.frame as _lz4frame
except ImportError:   # optional dependency (paper's lossless stage)
    _lz4frame = None

DEFAULT_BITS = (64, 32, 16, 8)

#: Lossless codecs for the post-quantization payload. "auto" resolves to
#: lz4 when importable, else zlib.
LOSSLESS_CODECS = ("zlib", "lz4", "auto")


def resolve_lossless_codec(codec: str) -> str:
    """Resolve a LOSSLESS_CODECS name to an available concrete codec."""
    if codec not in LOSSLESS_CODECS:
        raise ValueError(f"unknown lossless codec {codec!r}; available: "
                         f"{', '.join(LOSSLESS_CODECS)}")
    if codec == "auto":
        return "lz4" if _lz4frame is not None else "zlib"
    if codec == "lz4" and _lz4frame is None:
        warnings.warn("lz4 requested for the lossless stage but the lz4 "
                      "package is not importable; falling back to zlib",
                      RuntimeWarning, stacklevel=3)
        return "zlib"
    return codec


def lossless_compress(payload: bytes, codec: str = "zlib"
                      ) -> Tuple[bytes, str]:
    """Compress the shuffled payload; returns (blob, concrete codec)."""
    codec = resolve_lossless_codec(codec)
    if codec == "lz4":
        return _lz4frame.compress(payload), "lz4"
    return zlib.compress(payload, level=6), "zlib"


# ----------------------------------------------------------------------------
# Degree binning
# ----------------------------------------------------------------------------

def equal_length_thresholds(degrees: np.ndarray) -> Tuple[int, int, int]:
    """Four equal-length intervals over [0, D_max]. On heavy-tailed degree
    distributions this puts nearly every vertex in the first (widest-bit)
    bin, so it compresses poorly; kept for completeness."""
    dmax = max(int(degrees.max()), 4)
    return (dmax // 4, dmax // 2, 3 * dmax // 4)


def quantile_thresholds(degrees: np.ndarray) -> Tuple[int, int, int]:
    """Quartile thresholds of the empirical degree distribution — our
    default reading of the paper's 'four equal-length intervals based on
    the input graph's degree distribution': equal *mass* per interval,
    which is the only reading that yields meaningful compression on the
    heavy-tailed graphs of Table III."""
    qs = np.quantile(degrees, [0.25, 0.5, 0.75]).astype(np.int64)
    d1 = max(1, int(qs[0]))
    d2 = max(d1, int(qs[1]))
    d3 = max(d2, int(qs[2]))
    return (d1, d2, d3)


def assign_bits(degrees: np.ndarray,
                thresholds: Optional[Tuple[int, int, int]] = None,
                bits: Sequence[int] = DEFAULT_BITS) -> np.ndarray:
    """Per-vertex target bitwidth by degree interval (Fig. 9)."""
    if thresholds is None:
        thresholds = quantile_thresholds(degrees)
    d1, d2, d3 = thresholds
    assert d1 <= d2 <= d3, thresholds
    out = np.full(degrees.shape, bits[0], dtype=np.int64)
    out[degrees >= d1] = bits[1]
    out[degrees >= d2] = bits[2]
    out[degrees >= d3] = bits[3]
    return out


def theorem2_ratio(degree_cdf: Callable[[np.ndarray], np.ndarray],
                   thresholds: Tuple[int, int, int],
                   bits: Sequence[int] = DEFAULT_BITS,
                   q_input: int = 64) -> float:
    """Thm 2: ratio = q3/Q - (1/Q) sum_i F_D(D_i) (q_i - q_{i-1}).

    NOTE on the interval convention: the closed form holds when F_D(D_i) is
    the fraction of vertices in bins 0..i-1, i.e. P(D < D_i). For integer
    degrees that's CDF(D_i - 1), matching ``assign_bits``'s half-open
    intervals [D_{i}, D_{i+1}).
    """
    q0, q1, q2, q3 = bits
    d = np.asarray(thresholds, np.int64)
    f = np.asarray(degree_cdf(d - 1), np.float64)
    total = q3 - (f[0] * (q1 - q0) + f[1] * (q2 - q1) + f[2] * (q3 - q2))
    return float(total) / q_input


# ----------------------------------------------------------------------------
# Linear quantization per vertex
# ----------------------------------------------------------------------------

# sub-byte widths store in uint8 (levels = 2^b - 1 still apply; a real wire
# format would bit-pack them — nbytes() accounts for the logical bits)
_STORE_DTYPE = {2: np.uint8, 4: np.uint8, 8: np.uint8, 16: np.uint16,
                32: np.uint32, 64: np.uint64}


def _quantize_rows(x: np.ndarray, nbits: int):
    """Row-wise linear quantization to ``nbits``. Returns (q, mins, scales)."""
    mins = x.min(axis=1, keepdims=True)
    maxs = x.max(axis=1, keepdims=True)
    levels = float(2 ** min(nbits, 62) - 1)
    scales = np.maximum(maxs - mins, 1e-12) / levels
    q = np.clip(np.rint((x - mins) / scales), 0, levels)
    return q.astype(_STORE_DTYPE[nbits]), mins.squeeze(1), scales.squeeze(1)


def _dequantize_rows(q: np.ndarray, mins: np.ndarray, scales: np.ndarray):
    return (q.astype(np.float64) * scales[:, None] + mins[:, None])


@dataclasses.dataclass
class PackedFeatures:
    """DAQ output: vertices grouped by bitwidth + optional lossless payload."""
    num_vertices: int
    feature_dim: int
    bits_per_vertex: np.ndarray            # int64[|V|]
    groups: dict                           # nbits -> (vertex_ids, q, mins, scales)
    lossless_payload: Optional[bytes] = None
    lossless_codec: Optional[str] = None   # concrete codec of the payload

    @property
    def quant_bits(self) -> int:
        """Total feature payload bits after DAQ (before lossless)."""
        return int(self.bits_per_vertex.sum()) * self.feature_dim

    @property
    def raw_bits(self) -> int:
        return self.num_vertices * self.feature_dim * 64

    def nbytes(self, lossless: bool = True) -> int:
        if lossless and self.lossless_payload is not None:
            return len(self.lossless_payload)
        return self.quant_bits // 8

    @property
    def measured_ratio(self) -> float:
        return self.quant_bits / self.raw_bits


def byte_shuffle(a: np.ndarray) -> bytes:
    """HDF5-style shuffle filter: transpose byte planes of the elements."""
    b = np.ascontiguousarray(a).view(np.uint8).reshape(a.size, a.dtype.itemsize)
    return b.T.tobytes()


def daq_pack(features: np.ndarray, degrees: np.ndarray,
             thresholds: Optional[Tuple[int, int, int]] = None,
             bits: Sequence[int] = DEFAULT_BITS,
             lossless: bool = True,
             codec: str = "zlib") -> PackedFeatures:
    """Quantize features degree-aware, then shuffle + losslessly compress.

    The input is treated as Q=64-bit (the paper's raw feature width); the
    64-bit bin stores float64 verbatim (no quantization error). ``codec``
    selects the lossless stage ("zlib" | "lz4" | "auto"); "lz4" (the
    paper's choice) degrades to zlib with a warning when the lz4 package
    is not importable.
    """
    x = np.asarray(features, np.float64)
    degrees = np.asarray(degrees)
    bpv = assign_bits(degrees, thresholds, bits)
    groups = {}
    payload_parts = []
    for nbits in sorted(set(int(b) for b in bits), reverse=True):
        ids = np.flatnonzero(bpv == nbits)
        if ids.size == 0:
            continue
        rows = x[ids]
        if nbits >= 64:
            q, mins, scales = rows.view(np.uint64), None, None
        else:
            q, mins, scales = _quantize_rows(rows, nbits)
        groups[nbits] = (ids, q, mins, scales)
        payload_parts.append(byte_shuffle(q))
    payload = used_codec = None
    if lossless:
        payload, used_codec = lossless_compress(b"".join(payload_parts),
                                                codec)
    return PackedFeatures(num_vertices=x.shape[0], feature_dim=x.shape[1],
                          bits_per_vertex=bpv, groups=groups,
                          lossless_payload=payload,
                          lossless_codec=used_codec)


def daq_unpack(packed: PackedFeatures) -> np.ndarray:
    """Dequantize back to the original bitwidth (float64) in vertex order —
    the fog-side unpacking step; the 64-bit bin is exactly lossless."""
    out = np.zeros((packed.num_vertices, packed.feature_dim), np.float64)
    for nbits, (ids, q, mins, scales) in packed.groups.items():
        if nbits >= 64:
            out[ids] = q.view(np.float64)
        else:
            out[ids] = _dequantize_rows(q, mins, scales)
    return out


def uniform_pack(features: np.ndarray, nbits: int = 8,
                 lossless: bool = True) -> PackedFeatures:
    """Uniform quantization baseline (paper Table V 'Uni. 8-bit')."""
    degrees = np.zeros(features.shape[0], np.int64)
    return daq_pack(features, degrees, thresholds=(1, 1, 1),
                    bits=(nbits,) * 4, lossless=lossless)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A COMPRESSORS registry entry: one device-upload codec.

    ``roundtrip`` packs and unpacks features exactly as devices/fogs would,
    so downstream numerics carry the true quantization error. ``sim_key``
    is the wire-byte accounting key understood by
    ``simulation._partition_wire_bytes`` (None = raw upload).
    """
    name: str
    sim_key: Optional[str]
    pack: Optional[Callable[[np.ndarray, np.ndarray], PackedFeatures]]

    def roundtrip(self, features: np.ndarray,
                  degrees: np.ndarray) -> np.ndarray:
        if self.pack is None:
            return np.asarray(features, np.float32)
        packed = self.pack(np.asarray(features, np.float64), degrees)
        return daq_unpack(packed).astype(np.float32)


def _register_compressors():
    from repro_torch.api.registry import COMPRESSORS
    COMPRESSORS.register("none", Compressor("none", None, None))
    COMPRESSORS.register("daq", Compressor(
        "daq", "daq", lambda x, d: daq_pack(x, d)))
    COMPRESSORS.register("daq_noll", Compressor(
        "daq_noll", "daq_noll", lambda x, d: daq_pack(x, d, lossless=False)))
    # The paper's LZ4 lossless stage (optional lz4 dep; zlib fallback with
    # a warning). Numerics are identical to "daq" — only the lossless
    # payload (and hence the wire bytes) differs.
    COMPRESSORS.register("daq_lz4", Compressor(
        "daq_lz4", "daq_lz4", lambda x, d: daq_pack(x, d, codec="lz4")))
    COMPRESSORS.register("uniform8", Compressor(
        "uniform8", "uniform8", lambda x, d: uniform_pack(x, 8)))


_register_compressors()


def end_to_end_sizes(features: np.ndarray, degrees: np.ndarray,
                     **kw) -> dict:
    """Raw vs DAQ vs DAQ+lossless byte sizes (for communication accounting)."""
    packed = daq_pack(features, degrees, **kw)
    raw = features.shape[0] * features.shape[1] * 8
    return {
        "raw_bytes": raw,
        "daq_bytes": packed.quant_bits // 8,
        "wire_bytes": packed.nbytes(lossless=True),
        "daq_ratio": packed.measured_ratio,
        "wire_ratio": packed.nbytes(True) / raw,
    }
