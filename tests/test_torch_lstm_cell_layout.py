"""The LSTM-cell kernel's packed weight layout on the CPU
(``msa_tts_tpu_torch/experimental/cuda_lstm_cell.py``, the layout
``csrc/lstm_cell.cu`` reads).

- The packing round-trips bit for bit, f32 and bf16.
- A plain product computed from the packed slices in the kernel's own
  index order (f32: each lane's groups of 4 inputs, its float4 of four
  gates, the lanes' reduce-scatter, the warps, then the cluster's
  blocks in rank order; bf16: h rounded to bf16 as the A operand, each
  k-step's B fragments placed by ``frag_index``, one m16n8k16 product a
  tile) equals ``h @ w_hh_t``.  Tolerance: 1e-6 of the largest |value|, what
  f32 sums of ~1 000 unit-scale terms in another order can differ by.
- The packing is kept while the weight is unchanged and made again
  after an in-place update; the shared-memory plan fits.

No JAX here: the plain cell is held to the Pallas cell in
``tests/test_torch_gen_kernel.py``.
"""

import numpy as np
import pytest
import torch

from msa_tts_tpu_torch.experimental import cuda_lstm_cell as C
from msa_tts_tpu_torch.kernels.mma import frag_index

RTOL = 1e-6


def _weights(H, dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((H, 4 * H)) / H ** 0.5)
                         .astype(np.float32))
    return w.to(dtype)


def _h(B, H, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [64, 256, 1024])
def test_packing_round_trips(H, dtype):
    w = _weights(H, dtype)
    p = C.pack_weights(w)
    assert p.dtype == dtype and p.is_contiguous()
    U = C.UNITS
    if dtype == torch.float32:
        assert tuple(p.shape) == (H // U, H // 4, 4, U, 4)
    else:
        assert tuple(p.shape) == (H // U, C.k_steps(H), U // 4, 32, 2, 4)
    assert torch.equal(C.unpack_weights(p, H), w)


def _tree(parts):
    """The kernel's reduce-scatter order over a unit's KQ lanes: lanes
    16 apart first, then 8 apart."""
    while len(parts) > 1:
        half = len(parts) // 2
        parts = [parts[i] + parts[i + half] for i in range(half)]
    return parts[0]


def _f32_product(p, h):
    """gates (B, 4H) from the f32 packing, summed as the kernel does."""
    B, H = h.shape
    U, QG = C.UNITS, H // 4
    per = _cdiv(QG, C.KSPLIT)
    hq = h.reshape(B, QG, 4)
    # one group q of lane (kq, u): four FMAs a gate, inputs in order
    contrib = torch.zeros(QG, B, H // U, U, 4)
    for k in range(4):
        contrib += torch.einsum("jqug,bq->qbjug", p[:, :, k], hq[:, :, k])
    total = None
    for rank in range(C.KSPLIT):
        q_end = min(rank * per + per, QG)
        block = None
        for warp in range(C.NW):
            lanes = []
            for kq in range(C.KQ):
                acc = torch.zeros(B, H // U, U, 4)
                q = rank * per + warp * C.KQ + kq
                while q < q_end:
                    acc = acc + contrib[q]
                    q += C.NW * C.KQ
                lanes.append(acc)
            s = _tree(lanes)
            block = s if block is None else block + s
        total = block if total is None else total + block
    return total.permute(0, 3, 1, 2).reshape(B, 4 * H)


def _bf16_product(p, h):
    """gates (B, 4H) from the bf16 packing: per k-step, the A operand
    (16 rows of h rounded to bf16, zero rows past B) times each n8 tile
    whose B fragments lane l holds at frag_index(True), f32 sums."""
    B, H = h.shape
    U, T = C.UNITS, C.TILES
    KS = C.k_steps(H)
    per = _cdiv(KS, C.KSPLIT)
    hb = torch.nn.functional.pad(h.to(torch.bfloat16).float(),
                                 (0, 16 * KS - H, 0, 16 * _cdiv(B, 16) - B))
    fr, fc = (torch.as_tensor(a) for a in frag_index(True))
    # B tiles (j, s, tile, k, n) from the lanes' fragments
    frags = p.float().permute(0, 1, 2, 4, 3, 5).reshape(H // U, KS, T,
                                                         32, 4)
    tiles = torch.zeros(H // U, KS, T, 16, 8)
    tiles[:, :, :, fc, fr] = frags
    total = None
    for rank in range(C.KSPLIT):
        block = None
        for warp in range(C.NW):
            acc = torch.zeros(hb.shape[0], H // U, T, 8)
            s = rank * per + warp
            while s < min(rank * per + per, KS):
                a = hb[:, 16 * s:16 * s + 16]
                acc = acc + torch.einsum("bk,jtkn->bjtn", a, tiles[:, s])
                s += C.NW
            block = acc if block is None else block + acc
        total = block if total is None else total + block
    # column n of tile t: unit 2t + n // 4, gate n % 4
    total = total[:B].reshape(B, H // U, U, 4)
    return total.permute(0, 3, 1, 2).reshape(B, 4 * H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H", [(3, 64), (16, 256), (20, 80)])
def test_product_from_packed_slices(B, H, dtype):
    w, h = _weights(H, dtype, seed=B), _h(B, H, seed=H)
    p = C.pack_weights(w)
    if dtype == torch.float32:
        got, want = _f32_product(p, h), h @ w
    else:
        got = _bf16_product(p, h)
        want = h.to(torch.bfloat16).float() @ w.float()
    err = float((got - want).abs().max())
    assert err <= RTOL * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_packing_kept_until_the_weight_changes(dtype):
    w = _weights(64, dtype)
    first = C.packed_weights(w)
    assert C.packed_weights(w) is first
    with torch.no_grad():
        w[3, 5] += 1.0                        # in place: the version moves
    second = C.packed_weights(w)
    assert second is not first
    assert torch.equal(C.unpack_weights(second, 64), w)
    assert C.packed_weights(w) is second
    # another tensor with equal values gets a packing of its own
    assert C.packed_weights(w.clone()) is not second


def test_shared_memory_plan():
    """B = 16, H = 1024 leaves room for two blocks an SM (each at most
    half of 227 KB); every shape the card tests use fits a block."""
    for bf16 in (False, True):
        assert 2 * C.smem_bytes(16, 1024, bf16) <= C.SMEM_MAX
        for B in (1, 3, 16, 17, 20, 33, 100):
            for H in (64, 256, 1024):
                assert C.smem_bytes(B, H, bf16) <= C.SMEM_MAX
    assert C.bf16_tiles(16) == 1 and C.bf16_tiles(33) == 3
    assert C.bf16_tiles(1000) == C.MT_MAX
