"""The frozen work counts against hand counts at tiny shapes."""

from work import hifigan as WH
from work import peaks
from work import tacotron as WT
from work import wavernn as WW

M = {"encoder_embedding_dim": 4, "speaker_embedding_dim": 2,
     "symbols_embedding_dim": 4, "encoder_kernel_size": 3,
     "encoder_n_convolutions": 1, "attention_rnn_dim": 3,
     "decoder_rnn_dim": 2, "prenet_dim": 2, "n_mel_channels": 2,
     "n_frames_per_step": 1, "postnet_embedding_dim": 3,
     "postnet_kernel_size": 3, "postnet_n_convolutions": 2,
     "attention_params": {"attention_type": "LSA", "attention_dim": 2,
                          "attention_location_n_filters": 1,
                          "attention_location_kernel_size": 3}}


def test_decoder_step_weights_by_hand():
    E, H, Hd, P, MR, A = 6, 3, 2, 2, 2, 2
    hand = (P * MR + P * P + 4 * H * (P + E) + 4 * H * H + A * H
            + 4 * Hd * (H + E) + 4 * Hd * Hd + (MR + 1) * (Hd + E))
    assert WT.step_matrix_weights(M) == hand
    fa = dict(M, attention_params=dict(M["attention_params"],
                                       attention_type="ForwardAttention"))
    assert WT.step_matrix_weights(fa) == hand + H + E
    per_pos = 2 * 1 * 3 + 1 * 2 + 2 + 6
    assert WT.decoder_ops(M, 2, 5, 7) == 2 * 2 * 7 * (hand + 5 * per_pos)


def test_encoder_and_postnet_by_hand():
    assert WT.encoder_ops(M, 1, 5) == 2 * 5 * (4 * 4 * 3 + 2 * (8 * 4 + 8 * 2)
                                             + 2 * 6)
    assert WT.postnet_ops(M, 2, 10) == 2 * 2 * 10 * (2 * 3 * 3 + 3 * 2 * 3)


def test_launch_bytes_count_each_byte_once():
    b1 = WT.decoder_launch_bytes(M, [5], 7, 2)
    b2 = WT.decoder_launch_bytes(M, [5, 5], 7, 2)
    per_row = 4 * 5 * (6 + 2 + 1) + 4 * 7 * 2 * 2 + 4 * 7 * (3 + 5) + 4
    assert b2 - b1 == per_row


def test_wavernn_by_hand():
    v = {"rnn_dims": 4, "fc_dims": 3, "res_out_dims": 8, "compute_dims": 2,
         "res_blocks": 1, "pad": 1, "upsample_factors": [2]}
    d = 2
    hand = (3 * 4 * 4 * 2 + 3 * 4 * (4 + d) + 3 * 4 * 4 + 3 * (4 + d)
            + 3 * (3 + d) + 30 * 3 + 4)
    assert WW.loop_matrix_weights(v) == hand
    assert WW.loop_ops(v, 5, 11) == 2 * 5 * 11 * hand
    assert WW.loop_launch_bytes(v, 1, 1, 2) - WW.loop_launch_bytes(
        v, 1, 0, 2) == 4 * (4 + 3 * d + 10 + 2)


def test_hifigan_by_hand():
    h = {"upsample_initial_channel": 8, "upsample_rates": [2],
         "upsample_kernel_sizes": [4], "resblock": "1",
         "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 2]]}
    t = 5
    hand = 3 * 8 * 7 * t + 2 * 4 * 4 * 4 * t + 2 * 2 * 4 * 4 * 3 * 2 * t \
        + 4 * 7 * 2 * t
    assert WH.ops(h, 3, 1, t) == 2 * hand


def test_bound_picks_the_larger():
    t, by = peaks.bound_s(3.35e12, 1.0, "bfloat16")
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = peaks.bound_s(1.0, 989e12, "bfloat16")
    assert by == "operations" and abs(t - 1.0) < 1e-12
