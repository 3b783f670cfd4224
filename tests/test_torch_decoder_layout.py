"""The decoder kernels' weight layout and shared-memory plan
(msa_tts_tpu_torch/models/cuda_decoder.py), on the CPU: what
``split_decoder_params`` packs for float32 and bfloat16, a product
computed from the packed segments the way the kernel indexes them
(float32: a block's units, their gate rows, 16-byte vectors split over
two warps; bfloat16: a block's tiles of 4 units, 16-column tiles in the
tensor-core instruction's fragment order, split over the warps) against
the plain product, and ``smem_plan`` at the tiny and the shipped
widths.

Tolerances: a float32 product from the packed slices against
``x @ W.T``: 1e-5 (another summation order); the bfloat16 packing holds
the module's bfloat16 values exactly."""

import numpy as np
import pytest
import torch

from msa_tts_tpu_torch.models import cuda_decoder as CD
from msa_tts_tpu_torch.models.decoder import (
    Decoder,
    DecoderConfig,
    compute_view,
    decoder_infer,
)
from msa_tts_tpu_torch.models.tacotron2nv import config_from_params
from torch_parity import model_dict

SHIPPED = DecoderConfig(
    n_mel_channels=80, n_frames_per_step=2, encoder_embedding_dim=768,
    attention_rnn_dim=1024, decoder_rnn_dim=1024, prenet_dim=256,
    max_decoder_steps=500, gate_threshold=0.5, p_attention_dropout=0.1,
    p_decoder_dropout=0.1, early_stopping=True,
    attention_params={
        "attention_type": "ForwardAttention", "attention_dim": 128,
        "attention_location_n_filters": 32,
        "attention_location_kernel_size": 31,
    },
)


def _tiny(**over):
    return config_from_params(model_dict(**over)).decoder_config()


def _decoder(dcfg, dtype=torch.float32, seed=0):
    dec = Decoder(dcfg, generator=torch.Generator().manual_seed(seed))
    return dec.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_packing_round_trip(dtype):
    """Every packed matrix holds the module's values at the weight type
    (rows padded with zeros to 8 values), the vectors stay float32, and
    the packing of a bfloat16 decoder equals the bfloat16 packing of its
    float32 source."""
    dcfg = _tiny()
    dec32 = _decoder(dcfg)
    dec = _decoder(dcfg, dtype)
    w = CD.split_decoder_params(dec, dcfg)
    for k, shape in CD._packed_shapes(dcfg, dtype).items():
        assert tuple(w[k].shape) == shape, k
        assert w[k].dtype == (dtype if k in CD._MATRICES
                              else torch.float32), k
        assert w[k].is_contiguous(), k
    cast = CD.split_decoder_params(dec32, dcfg, dtype)
    for k in CD._MATRICES:
        assert torch.equal(w[k], cast[k]), k
    P, H = dcfg.prenet_dim, dcfg.attention_rnn_dim
    src = dec.attention_rnn.weight_ih[:, :P].reshape(4, H, P)
    rows = _unit_major_rows(w["wa_p"], dtype)
    assert torch.equal(rows[: 4 * H, :P],
                       src.transpose(0, 1).reshape(4 * H, P))
    assert not rows[4 * H:].any() and not rows[:, P:].any()
    # the prenet's matrices: rows in float32, 16 x 16 tiles in bfloat16
    for key, layer in (("w_pre1", 0), ("w_pre2", 1)):
        src = dec.prenet.layers[layer].linear_layer.weight
        rows = (w[key] if dtype == torch.float32
                else _unit_major_rows(w[key], dtype))
        assert torch.equal(rows[: src.shape[0], : src.shape[1]], src), key
        assert not rows[src.shape[0]:].any(), key
        assert not rows[:, src.shape[1]:].any(), key
    # the two biases are summed at the weight type (as the JAX kernel's
    # packing sums its cast parameters) and held in float32
    for key, cell in (("b_att", dec.attention_rnn),
                      ("b_dec", dec.decoder_rnn)):
        want = (cell.bias_ih + cell.bias_hh).float()
        assert torch.equal(w[key], want) and torch.equal(cast[key], want)
    with pytest.raises(TypeError):
        CD.split_decoder_params(dec32, dcfg, torch.float16)


def _unit_major_rows(seg, dtype):
    """A packed segment back as (rows, columns), row = unit * 4 + gate:
    float32 (N, 4, ld) flattened; bfloat16 tiles (ut, kt, 32 lanes, 8)
    read through the A-operand fragment map of mma.sync.m16n8k16 (lane =
    4 * group + t; registers a0-a3 = rows group / group + 8, columns 2t,
    2t + 1 / + 8)."""
    if dtype == torch.float32:
        return seg.reshape(-1, seg.shape[-1])
    ut, kt = seg.shape[:2]
    tiles = torch.zeros(ut, kt, 16, 16, dtype=seg.dtype)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for e in range(8):
            reg, hi = e >> 1, e & 1
            tiles[:, :, g + 8 * (reg & 1), 2 * t + hi + 8 * (reg >> 1)] = \
                seg[:, :, lane, e]
    return tiles.transpose(1, 2).reshape(ut * 16, kt * 16)


def _kernel_product(seg, x, n_sm, dtype):
    """gates (B, 4N) of one packed segment against x (B, n), summed as
    the kernel sums.  float32: block k owns units [k·upb, (k+1)·upb); a
    unit's four gate rows are consecutive; two warps take the two halves
    of a row's 16-byte vectors, lanes stride them; the halves are added
    last.  bfloat16: block k owns unit tiles [k·tpb, (k+1)·tpb); warp w
    takes the column tiles w // tpp, + nks, ... of unit tile w % tpp
    (each a 16 x 16 product summed inside the instruction), and the nks
    warps' sums are added in order."""
    B, n = x.shape
    if dtype == torch.float32:
        N, _, ld = seg.shape
        epv = 4
        xs = torch.zeros(B, ld)
        xs[:, :n] = x
        nv = ld // epv
        half = (nv + 1) // 2
        upb = CD.units_per_block(N, n_sm, dtype)
        out = torch.zeros(B, 4 * N)
        flat = seg.float().reshape(-1)
        for k in range(n_sm):
            for slot in range(upb):
                u = k * upb + slot
                if u >= N:
                    continue
                for g in range(4):
                    row = flat[(u * 4 + g) * ld: (u * 4 + g + 1) * ld]
                    sides = []
                    for lo, hi in ((0, half), (half, nv)):
                        lanes = torch.zeros(B, 32)
                        for i in range(lo, hi):
                            v = slice(i * epv, (i + 1) * epv)
                            lanes[:, (i - lo) % 32] += xs[:, v] @ row[v]
                        sides.append(lanes.sum(1))
                    out[:, g * N + u] = sides[0] + sides[1]
        return out
    ut, kt = seg.shape[:2]
    rows = _unit_major_rows(seg, dtype).float().reshape(ut, 16, kt, 16)
    xs = torch.zeros(B, kt * 16)
    xs[:, :n] = x
    xs = xs.reshape(B, kt, 16)
    tpb = -(-ut // n_sm)
    tpp = min(tpb, 16)
    nks = 16 // tpp
    acc = torch.zeros(B, ut * 16)
    for tile in range(ut):
        parts = [sum((xs[:, k] @ rows[tile, :, k].T for k in
                      range(ks, kt, nks)), torch.zeros(B, 16))
                 for ks in range(nks)]
        total = torch.zeros(B, 16)
        for part in parts:
            total = total + part
        acc[:, tile * 16: (tile + 1) * 16] = total
    # rows are unit * 4 + gate; the cell's gates are gate-major
    n_units = 4 * ut
    return acc.reshape(B, n_units, 4).transpose(1, 2).reshape(B, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_sm", [132, 7, 2])
def test_product_from_packed_segments(dtype, n_sm):
    """The sum of the three segments' products, taken from the packed
    slices as the kernel indexes them, plus the packed bias, is the
    cell's gate pre-activation: for bfloat16 with the inputs rounded, as
    the plain bfloat16 step computes it."""
    dcfg = _tiny()
    dec = _decoder(dcfg, dtype)
    w = CD.split_decoder_params(dec, dcfg)
    shadow, rnd = compute_view(dec)
    g = torch.Generator().manual_seed(1)
    P, E = dcfg.prenet_dim, dcfg.encoder_embedding_dim
    H, Hd = dcfg.attention_rnn_dim, dcfg.decoder_rnn_dim
    for cell, names, cuts, bias in (
        (shadow.attention_rnn, ("wa_p", "wa_c", "wa_h"), (P, E, H), "b_att"),
        (shadow.decoder_rnn, ("wd_h", "wd_c", "wd_hd"), (H, E, Hd), "b_dec"),
    ):
        x = rnd(torch.randn(3, cell.input_size + cell.hidden_size,
                            generator=g))
        n4 = 4 * cell.hidden_size
        got = w[bias].clone()
        for name, piece in zip(names, x.split(cuts, dim=1)):
            gates = _kernel_product(w[name], piece, n_sm, dtype)
            # bfloat16 pads the units to whole tiles of 4: gate-major
            # columns of the padded unit count
            pad_units = gates.shape[1] // 4
            gates = gates.reshape(3, 4, pad_units)[:, :, : cell.hidden_size]
            got = got + gates.reshape(3, n4)
        xi, h = x[:, : cell.input_size], x[:, cell.input_size:]
        want = (xi @ cell.weight_ih.T + h @ cell.weight_hh.T
                + cell.bias_ih + cell.bias_hh)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("T_in", [120, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_smem_plan_shipped_width(dtype, T_in, B):
    """At the shipped width on 132 SMs every (B, T_in) fits a block's
    232,448 bytes; the segments whose products wait on an exchange
    (prenet columns, the decoder LSTM's context columns) are resident in
    both types, bfloat16 also keeps the decoder LSTM's attention-h
    columns; what is not resident is streamed, and the two add up to the
    LSTM weights."""
    plan = CD.smem_plan(SHIPPED, B, T_in, dtype)
    assert plan["grid"] == 132
    assert plan["fixed_bytes"] < plan["smem_bytes"] <= CD.SMEM_MAX
    assert plan["resident"][:2] == ("wa_p", "wd_c")
    esz = 2 if dtype == torch.bfloat16 else 4
    total = 4096 * (256 + 768 + 1024) * esz + 4096 * (1024 + 768 + 1024) * esz
    assert plan["resident_bytes"] + plan["streamed_bytes"] == total
    if dtype == torch.bfloat16:
        assert "wd_h" in plan["resident"]
        # 8 units (2 tiles) a block, 128 blocks: what a block keeps,
        # times 128
        per_block = sum(8 * 4 * {"wa_p": 256, "wd_c": 768, "wd_h": 1024,
                                 "wd_hd": 1024, "wa_c": 768,
                                 "wa_h": 1024}[n] * 2
                        for n in plan["resident"])
        assert CD.units_per_block(1024, 132, dtype) == 8
        assert plan["resident_bytes"] == 128 * per_block
        assert plan["smem_bytes"] == plan["fixed_bytes"] + per_block
    mask = sum(1 << CD.SEGMENTS.index(n) for n in plan["resident"])
    assert plan["res_mask"] == mask


def test_smem_plan_tiny_and_too_large():
    """A tiny decoder keeps every segment resident; a shape whose working
    space alone exceeds a block raises, it does not pick another path."""
    dcfg = _tiny()
    plan = CD.smem_plan(dcfg, 3, 11, torch.bfloat16)
    assert set(plan["resident"]) == set(CD.SEGMENTS)
    assert plan["streamed_bytes"] == 0 and plan["res_mask"] == 63
    with pytest.raises(ValueError, match="shared memory"):
        CD.smem_plan(SHIPPED, 4, 30000, torch.float32)
    # fewer SMs: more units a block, so less of them stays resident
    few = CD.smem_plan(SHIPPED, 4, 120, torch.bfloat16, n_sm=16)
    assert few["resident_bytes"] < CD.smem_plan(
        SHIPPED, 4, 120, torch.bfloat16)["resident_bytes"]


def test_packed_params_follow_the_type():
    """One packing per decoder, the one of its current type: casting the
    decoder repacks, and the float32 packing is gone."""
    dcfg = _tiny()
    dec = _decoder(dcfg)
    w32 = CD._packed_params(dec, dcfg)
    assert w32["wa_h"].dtype == torch.float32
    dec.to(torch.bfloat16)
    w16 = CD._packed_params(dec, dcfg)
    assert w16["wa_h"].dtype == torch.bfloat16
    assert CD._packed_params(dec, dcfg) is w16
    assert CD._PACKED[dec][1] is w16


def test_plain_bf16_decode_rounds_product_inputs_only():
    """The plain bfloat16 loop is the float32 loop of the bfloat16 values
    with the product inputs rounded: close to float32 (first step within
    2e-2), float32 outputs and state, and exactly reproducible."""
    dcfg = _tiny(decoder_no_early_stopping=True)
    dec32 = _decoder(dcfg)
    dec16 = _decoder(dcfg, torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    enc = torch.randn(2, 9, dcfg.encoder_embedding_dim, generator=g)
    lens = torch.tensor([9, 6])
    masks = CD.prenet_masks(dcfg, dcfg.max_decoder_steps, 2, g, device="cpu")
    a = decoder_infer(dec32, dcfg, enc, lens, masks)
    b = decoder_infer(dec16, dcfg, enc.to(torch.bfloat16), lens, masks)
    c = decoder_infer(dec16, dcfg, enc.to(torch.bfloat16), lens, masks)
    r = dcfg.n_frames_per_step
    for x, y, z in zip(a[:3], b[:3], c[:3]):
        assert y.dtype == torch.float32 and x.shape == y.shape
        assert torch.equal(y, z)
    np.testing.assert_allclose(b[0][..., :r].numpy(), a[0][..., :r].numpy(),
                               atol=2e-2, rtol=0)
    assert torch.isfinite(b[0]).all()
    assert b[3].tolist() == a[3].tolist()
