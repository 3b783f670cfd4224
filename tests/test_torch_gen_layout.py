"""What of the WaveRNN sample-loop kernel (K3) can be held on the CPU:
the packed weight layout of ``cuda_gen.kernel_weights`` (each block's
resident slice in tensor-core fragment order) against the module's
matrices, a product computed from the packed slices the way the kernel
indexes them, the shared-memory budget, and the device defaults of the
port's entry points (``cuda``; they raise where there is no GPU)."""

import inspect

import numpy as np
import pytest
import torch

from msa_tts_tpu_torch import server, serving
from msa_tts_tpu_torch.utils.backend import load_device
from msa_tts_tpu_torch.vocoders import cuda_gen as G
from msa_tts_tpu_torch.vocoders import hifigan as H
from msa_tts_tpu_torch.vocoders import wavernn as W

TINY = dict(rnn_dims=64, fc_dims=64, res_out_dims=32, n_mels=20,
            res_blocks=2, hop_length=16, pad=2, upsample_factors=(2, 2, 4))


def _params(dtype, **over):
    cfg = W.WaveRNNConfig(**over)
    model = W.WaveRNNModel(cfg, torch.Generator().manual_seed(0))
    return cfg, W.cast_generation_params(model, dtype)


# 7 blocks give a block several tiles of units; the default width fits
# only a grid of the card's size
@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("over,n_blocks", [
    (dict(TINY), 132), (dict(TINY), 7),
    (dict(TINY, use_aux_net=False), 132), (dict(TINY, use_aux_net=False), 7),
    (dict(TINY, mode="GAUSS"), 7), (dict(), 132),
    (dict(use_aux_net=False), 132),
], ids=["tiny", "tiny-7", "tiny-noaux", "tiny-noaux-7", "tiny-gauss-7",
        "default", "default-noaux"])
def test_kernel_weights_round_trip(over, dtype, n_blocks):
    cfg, gp = _params(dtype, **over)
    w = G.kernel_weights(gp, cfg, n_blocks)
    assert w["n_blocks"] == n_blocks and w["dtype"] == (
        dtype or torch.float32)
    back = G.unpack_kernel_weights(w, cfg)
    for key, layer, name, _ in G._MATS:
        assert back[key].dtype == gp[layer][name].dtype, key
        assert torch.equal(back[key], gp[layer][name]), key
    for key, layer, name in G._VECS:
        assert torch.equal(w[key], gp[layer][name]), key
    assert torch.equal(w["w_x"], gp["I"]["weight"][:, 0].float())
    if dtype is not None:
        pl = G.kernel_plan(cfg, n_blocks, True)
        assert tuple(w["packed"].shape) == (n_blocks, pl["w_bytes"] // 2)
        assert w["packed"].is_contiguous()
        # every matrix value sits in exactly one block's slice, fc3 in all
        n_mat = sum(gp[layer][name].numel()
                    for _, layer, name, kind in G._MATS if kind != "fc3")
        n_fc3 = gp["fc3"]["weight"].numel()
        nonzero = int((w["packed"] != 0).sum())
        zeros = sum(int((gp[layer][name] == 0).sum())
                    for _, layer, name, _ in G._MATS)
        assert nonzero <= n_mat + n_blocks * n_fc3
        assert nonzero >= n_mat + n_blocks * n_fc3 - n_blocks * zeros


def _mma(a_frag, x, half):
    """What ``mma.sync.m16n8k16`` sums from one lane-ordered A tile
    (32, 8 or 4) and 16 inputs of 8 batch rows x (8, 16): the (16, 8)
    tile of sums, by the instruction's fragment layout."""
    fr, fc = G._frag_index(half)
    a = np.zeros((16, 16), np.float32)
    a[fr, fc] = a_frag
    return a @ x.T


def test_product_from_packed_slices_is_the_plain_product():
    """GRU 2's input product and fc2, computed block by block from the
    packed slices with the kernel's indexing (tile, k-step, fragment
    order; a unit's gate rows at (unit % 5)·3 + gate of tile unit // 5;
    an fc output at row unit % 8), equal x @ W.T on bf16 values."""
    n_blocks = 7
    cfg, gp = _params(torch.bfloat16, **TINY)
    R, F_, D, _, _ = G._cfg_dims(cfg)
    w = G.kernel_weights(gp, cfg, n_blocks)
    pl = G.kernel_plan(cfg, n_blocks, True)
    packed = w["packed"].float().numpy()
    offs = np.cumsum([0] + pl["sections"]) // 2
    rng = np.random.default_rng(0)
    for sec, key, kind, tiles, ks, k_in, n_out, gates in (
            (2, "rnn2", "gru", pl["tg"], pl["ks_rd"], R + D, R, 3),
            (5, "fc2", "fc", pl["tf"], pl["ks_fd"], F_ + D, F_, 1)):
        x = torch.from_numpy(rng.standard_normal((8, k_in)).astype(
            np.float32)).bfloat16().float().numpy()
        xp = np.pad(x, ((0, 0), (0, 16 * ks - k_in)))
        wname = "weight_ih" if kind == "gru" else "weight"
        want = x @ gp[key][wname].float().numpy().T        # (8, gates·n_out)
        half = kind == "fc"
        e, per = (4, G.FC_PER_TILE) if half else (8, G.GRU_PER_TILE)
        got = np.full_like(want, np.nan)
        for j in range(n_blocks):
            sl = packed[j, offs[sec]: offs[sec + 1]].reshape(
                tiles, ks, 32, e)
            slots = len(range(j, n_out, n_blocks))
            for s in range(slots):
                ti, si = divmod(s, per)
                acc = sum(_mma(sl[ti, k], xp[:, 16 * k: 16 * k + 16], half)
                          for k in range(ks))              # (16, 8)
                for gate in range(gates):
                    row = si * 3 + gate if kind == "gru" else si
                    got[:, gate * n_out + j + s * n_blocks] = acc[row]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_smem_budget_accepts_the_default_width_and_refuses_a_wide_one():
    cfg = W.WaveRNNConfig()
    # a block's slices: 4 units x 6 gate rows (padded to two 16-row
    # tiles) per GRU, 4 outputs (8-row tiles) per fc, fc3 whole
    res = G.kernel_plan(cfg, G.H100_SMS, True, by_phase=False)
    assert res["sections"] == [16384, 16384, 17408, 16384, 8704, 8704,
                               32768]
    # few rows: the whole slice stays in shared memory, two buffers of 24
    # rows of 1,104 input and 1,040 hidden-state bytes beside it
    assert res["w_bytes"] == res["w_smem"] == 116736 and not res["by_phase"]
    assert (res["stride_a"], res["stride_h"]) == (1104, 1040)
    assert (res["ch"], res["ch_fc"]) == (24, 24)
    assert res["off_misc"] < res["total"] == 232416 <= G.SMEM_MAX
    # many rows: one phase's weights at a time (GRU 2's two matrices the
    # most), 40-row GRU chunks and 72-row fc chunks
    pl = G.kernel_plan(cfg, G.H100_SMS, True)
    assert pl["by_phase"] and pl["w_smem"] == 17408 + 16384
    assert (pl["ch"], pl["ps"], pl["ch_fc"], pl["ps_fc"]) == (40, 40, 72, 72)
    assert pl["off_part"] - pl["off_stage"] == 2 * 40 * 2144
    assert pl["total"] == 226272 <= G.SMEM_MAX
    # f32: one buffer for the largest phase (fc3: 30 rows of 516 floats)
    pf = G.kernel_plan(cfg, G.H100_SMS, False, by_phase=False)
    assert pf["by_phase"] and pf["w_smem"] == 30 * 516 * 4
    assert (pf["ch"], pf["ch_fc"]) == (16, 24)
    # rnn and fc 1,024 fit in bf16 by phase (8 rows a chunk) only
    wide = W.WaveRNNConfig(rnn_dims=1024, fc_dims=1024)
    assert G.kernel_plan(wide, G.H100_SMS, True)["ch"] == 8
    with pytest.raises(ValueError, match=r"\(363520 of every phase's "
                       r"weights, the rest staging for 8 rows\)"):
        G.kernel_plan(wide, G.H100_SMS, True, by_phase=False)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        G.kernel_plan(wide, G.H100_SMS, False)
    wider = W.WaveRNNConfig(rnn_dims=1536, fc_dims=1536)
    with pytest.raises(ValueError, match=r"need 410592 bytes .* \(297984 "
                       r"of one phase's weights, the rest staging for 8 "
                       r"rows\)"):
        G.kernel_plan(wider, G.H100_SMS, True)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        G.kernel_weights(_params(torch.bfloat16, rnn_dims=1536,
                                 fc_dims=1536)[1], wider, G.H100_SMS)


@pytest.mark.parametrize("bf16,by_phase", [(False, True), (True, True),
                                           (True, False)],
                         ids=["f32", "bf16", "bf16-resident"])
@pytest.mark.parametrize("R,F_,D,n_blocks", [
    (512, 512, 32, 132), (512, 512, 0, 132), (64, 64, 8, 132),
    (64, 64, 8, 7), (384, 768, 32, 132), (576, 512, 32, 132),
    (256, 256, 32, 132),
], ids=["default", "default-noaux", "tiny", "tiny-7", "fc-wide",
        "rnn-wide", "narrow"])
def test_staging_takes_the_largest_chunks(R, F_, D, n_blocks, bf16,
                                          by_phase):
    """Beside the weights in shared memory (one phase's, the largest
    phase's room, or bf16's whole slice), the staging takes the most rows
    of 40, 32, 24, 16, 8 that fit; with weights by phase an fc phase,
    whose rows hold no hidden state, takes 8 more at a time while its
    input rows fit the same two buffers and its partial sums the same
    room; every pitch has a column for every staged row and every buffer
    starts where a 16-byte copy may land."""
    pl = G.smem_plan(R, F_, D, 30, 10, n_blocks, bf16, by_phase)
    sec = pl["sections"]
    if pl["by_phase"]:
        assert pl["w_smem"] == max(sec[0] + sec[1], sec[2] + sec[3],
                                   *sec[4:]) < pl["w_bytes"]
    else:
        assert pl["w_smem"] == pl["w_bytes"]
    assert pl["off_stage"] == pl["w_smem"]
    assert pl["fits"] and pl["total"] <= G.SMEM_MAX
    ch, ps, mr = pl["ch"], pl["ps"], pl["m_rows"]
    assert ch in (8, 16, 24, 32, 40) and ps >= ch and ps % 16 == 8
    stage = G.N_BUFFERS * ch * (pl["stride_a"] + pl["stride_h"])
    assert pl["off_part"] - pl["off_stage"] == stage
    if ch < 40:                     # 8 more rows do not fit
        part = (2 if bf16 else 1) * pl["ksplit"] * mr * G._part_pitch(
            ch + 8) * 4
        misc = pl["total"] - pl["off_misc"]
        more = G.N_BUFFERS * (ch + 8) * (pl["stride_a"] + pl["stride_h"])
        assert pl["off_stage"] + more + part + misc > G.SMEM_MAX
    cf, pf, fc_rows = pl["ch_fc"], pl["ps_fc"], 16 * pl["tf"]
    assert cf >= ch and cf % 8 == 0 and pf >= cf and pf % 16 == 8
    assert G.N_BUFFERS * cf * pl["stride_a"] <= stage
    assert fc_rows * pf <= mr * ps
    if pl["by_phase"]:
        assert (G.N_BUFFERS * (cf + 8) * pl["stride_a"] > stage
                or fc_rows * G._part_pitch(cf + 8) > mr * ps)
    else:
        assert (cf, pf) == (ch, ps)
    for key in ("off_stage", "off_part", "off_misc", "stride_a",
                "stride_h"):
        assert pl[key] % 16 == 0, key


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    for fn in (serving.AdaptiveTTS.from_experiment, W.get_wavernn,
               H.HiFiGAN.__init__, load_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert server._arg_parser().get_default("device") == "cuda"
    # wrappers of a module the caller placed follow that module
    for fn in (serving.AdaptiveTTS.__init__, W.WaveRNN.__init__,
               H.HiFiGAN.from_params):
        assert inspect.signature(fn).parameters["device"].default is None
    assert load_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults load onto it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serving.AdaptiveTTS.from_experiment(str(tmp_path))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        W.WaveRNN(cfg=W.WaveRNNConfig(**TINY))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        W.get_wavernn(checkpoint_path=str(tmp_path / "none.pt"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        H.HiFiGAN(str(tmp_path / "c.json"), str(tmp_path / "g.pt"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        server.main(["--experiment_path", str(tmp_path)])
    voc = W.WaveRNN(cfg=W.WaveRNNConfig(**TINY), device="cpu")
    assert voc.device.type == "cpu"
    assert next(voc.model.parameters()).device.type == "cpu"
