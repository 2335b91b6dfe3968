"""The operation counts against hand counts at a tiny shape."""

import pytest

from uvbench import weights, work

TINY = {
    "model_type": "qwen3", "hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1,
    "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4, "vocab_size": 10,
    "rope_theta": 1e6, "rms_norm_eps": 1e-6,
    "audio_config": {"num_mel_bins": 2, "d_model": 4, "encoder_layers": 1,
                     "encoder_attention_heads": 1, "encoder_ffn_dim": 8, "max_source_positions": 8},
    "projector": {"hidden_size": 6, "stack_factor": 2, "projector_ln_mid": True, "norm_init": 0.4},
    "audio_lora": {"r": 1, "lora_alpha": 8, "target_modules": ["q_proj", "v_proj"]},
}


def test_train_micro_step_by_hand():
    m = weights.dims(TINY)
    row = work.Row(frames=8, student=5, teacher=3, predicted=2)
    # encoder, 4 positions: layers 2*4*(4*4^2 + 2*4*8) = 1024, conv stem
    # 2*3*(8*2*4 + 4*4*4) = 768, attention 4*4^2*4 = 256; forward and input
    # gradient of the products (x2), attention's forward and backward (x3)
    encoder = 2 * (1024 + 768) + 3 * 256
    lora = 3 * 4 * (2 * 2 * 4 * 1 * 2)  # q and v adapters at r 1: forward and both gradients
    projector = 3 * 2 * 2 * (4 * 2 * 6 + 3 * 8)  # 2 stacked positions, forward and both gradients
    layer = 8 * (8 + 2 * 4) + 8 * 8 + 3 * 8 * 16  # q/k/v, o, gate/up/down = 576
    student = 2 * (2 * 5 * layer) + 3 * (4 * 2 * 4 * 15)  # 15 causal pairs of 5 tokens
    teacher = 2 * 3 * layer + 4 * 2 * 4 * 6  # 6 causal pairs of 3 tokens
    heads = 3 * 2 * 8 * 10 * (2 + 1)  # the predicted rows and the end-of-turn row
    assert work.train_micro_step(m, [row]) == encoder + lora + projector + student + teacher + heads


def test_train_counts_real_tokens_not_padding():
    m = weights.dims(TINY)
    a, b = work.Row(8, 5, 3, 2), work.Row(4, 9, 7, 1)
    assert work.train_micro_step(m, [a, b]) == pytest.approx(
        work.train_micro_step(m, [a]) + work.train_micro_step(m, [b]))


def test_serving_counts():
    m = weights.dims(TINY)
    assert work.attn_pairs(0, 4) == 10 and work.attn_pairs(3, 2) == 2 * 3 + 3
    p = work.prefill(m, start=3, n=5, chunk=2)  # chunks of 2, 2 and 1 new positions
    layer = 576
    flops = 2 * layer * 5 + 4 * 2 * 4 * (work.attn_pairs(3, 2) + work.attn_pairs(5, 2)
                                         + work.attn_pairs(7, 1)) + 2 * 8 * 10
    assert p.flops == flops
    assert p.nbytes == 3 * layer * 2 + (5 + 7 + 8) * work.kv_bytes_per_token(m) + 8 * 10 * 2
    d = work.decode_tokens(m, [4, 6])
    assert d.nbytes == 10 * 1 * 2 * 1 * 4 * 2
    assert work.decode_steps(m, 3).nbytes == 3 * (layer + 80) * 2
