"""AWQ w4-g128 file-layout packing and the NumPy dequant oracle.

The file-layout half of llama_cu_awq_tpu/quant/packing.py (its pair-planar
TPU layout has no counterpart here: the GPU kernels read the file's own
layout, see quant/qtensor.py).

For a logical weight W of shape (n_in, n_out) with out = x @ W, group size
128 along n_in, the `.bin` stores (reference: weight_packer.cpp:94-144):

  qweight: uint32[n_out, ceil(n_in/32)*4]; word [x, y] packs rows
           8y .. 8y+7 of column x, little-endian nibbles (nibble i = row
           8y+i). Words beyond ceil(n_in/8) are alignment padding.
  qzeros:  uint32[n_out, ceil(g/8)], g = ceil(n_in/128); nibble i of word
           [x, y] is the zero point of group 8y+i of column x.
  scales:  float16[n_out, g].

The NumPy in-memory layout (RawQWeight) is the transposed, unpadded one:
qw uint32 (ceil(n_in/8), n_out), zeros int8 (g, n_out), scales f32
(g, n_out), exactly as the JAX package holds it, so checkpoints and test
tensors carry across unchanged.

Dequantization: w[y, x] = (q[y, x] - zero[y//128, x]) * scale[y//128, x]
(reference: gpu_kernels.h:171-210).
"""

from __future__ import annotations

import numpy as np

from llama_cu_awq_torch.config import GROUP_SIZE


def div_up(a: int, b: int) -> int:
    return -(-a // b)


def packed_weight_height(n: int) -> int:
    """File-layout padded packed height (reference: llama2_q4.cu:82-88)."""
    return div_up(n, 32) * 4


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """Pack int values 0..15 of shape (n, d) into uint32 (ceil(n/8), d).

    Nibble i (little-endian) of word y holds row 8*y + i.
    """
    n, d = q.shape
    rows = div_up(n, 8) * 8
    qp = np.zeros((rows, d), dtype=np.uint32)
    qp[:n] = q.astype(np.uint32) & 0xF
    qp = qp.reshape(rows // 8, 8, d)
    shifts = (4 * np.arange(8, dtype=np.uint32)).reshape(1, 8, 1)
    return np.bitwise_or.reduce(qp << shifts, axis=1).astype(np.uint32)


def unpack_nibbles(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_nibbles: uint32 (ceil(n/8), d) -> int8 (n, d)."""
    nw, d = packed.shape
    shifts = (4 * np.arange(8, dtype=np.uint32)).reshape(1, 8, 1)
    vals = (packed.reshape(nw, 1, d) >> shifts) & np.uint32(0xF)
    return vals.reshape(nw * 8, d)[:n].astype(np.int8)


# ---------------------------------------------------------------------------
# file layout <-> in-memory layout

def qweight_file_to_mem(qw_file: np.ndarray, n: int) -> np.ndarray:
    """uint32 (width, packed_wt_height) -> uint32 (ceil(n/8), width)."""
    return np.ascontiguousarray(qw_file[:, : div_up(n, 8)].T)


def qweight_mem_to_file(qw: np.ndarray, n: int) -> np.ndarray:
    nw, width = qw.shape
    out = np.zeros((width, packed_weight_height(n)), dtype=np.uint32)
    out[:, :nw] = qw.T
    return out


def zeros_file_to_mem(qz_file: np.ndarray, n: int) -> np.ndarray:
    """uint32 (width, ceil(g/8)) -> int8 (g, width)."""
    g = div_up(n, GROUP_SIZE)
    return unpack_nibbles(np.ascontiguousarray(qz_file.T), g)


def zeros_mem_to_file(zeros: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(pack_nibbles(zeros).T)


def scales_file_to_mem(s_file: np.ndarray) -> np.ndarray:
    """float16 (width, g) -> float32 (g, width) (exact widening)."""
    return s_file.T.astype(np.float32)


def scales_mem_to_file(scales: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(scales.T.astype(np.float16))


# ---------------------------------------------------------------------------

def dequantize_np(qw: np.ndarray, zeros: np.ndarray, scales: np.ndarray,
                  n: int) -> np.ndarray:
    """Exact f32 dequantization of the in-memory layout -> (n, width).

    w = (q - z) * s per element in float32, as the reference kernel does
    (gpu_kernels.h:196-197).
    """
    q = unpack_nibbles(qw, n).astype(np.float32)
    gidx = np.arange(n) // GROUP_SIZE
    z = zeros.astype(np.float32)[gidx]
    s = scales.astype(np.float32)[gidx]
    return (q - z) * s


def quantize_np(w: np.ndarray, group_size: int = GROUP_SIZE):
    """Simple AWQ-style asymmetric w4 quantizer (tests & synthetic models).

    Returns (qw_mem uint32, zeros int8 (g,d), scales f32 (g,d)) such that
    dequantize_np() approximates w (n, d).
    """
    n, d = w.shape
    g = div_up(n, group_size)
    q = np.zeros((n, d), dtype=np.int32)
    zeros = np.zeros((g, d), dtype=np.int8)
    scales = np.zeros((g, d), dtype=np.float32)
    for gi in range(g):
        sl = slice(gi * group_size, min((gi + 1) * group_size, n))
        wg = w[sl]
        wmin, wmax = wg.min(axis=0), wg.max(axis=0)
        scale = np.maximum((wmax - wmin) / 15.0, 1e-8).astype(np.float16)
        zero = np.clip(np.round(-wmin / scale.astype(np.float32)), 0, 15)
        scales[gi] = scale.astype(np.float32)
        zeros[gi] = zero.astype(np.int8)
        q[sl] = np.clip(
            np.round(wg / scale.astype(np.float32) + zero), 0, 15
        ).astype(np.int32)
    return pack_nibbles(q), zeros, scales
