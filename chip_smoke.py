"""Smoke run of ultravox_torch on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel of the port from ultravox_torch/ops/kernels/csrc
     (one nvcc per source, all thirteen at once); the bf16 kernels of
     flash_attention, attention (#3/#4), encoder_attn_probe (#15/#16),
     decode_matmul (#14, bf16 x), ln_qkv_head (#2), ln_matmul_gelu (#6) and
     attn_out_proj (#7, three tile instances each) must hold tensor-core
     instructions (HMMA in cuobjdump's
     SASS; the fp32 ones none) and ptxas must report no spills for them
     (the attention kernels at head_dim 64),
     nor for the split KV kernel (csrc/kv_split.cuh, both dtypes) at
     head_dim 64, in its contiguous (#8, #11) and paged (#9, #12) instances;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the flagship paths give it (bf16; the decode and paged kernels
     also in fp32, with ragged lengths, windows, pages of 16 and 48, shuffled
     page ids, sentinel entries, a pageless row, two runs bit-equal, and junk
     in every slot a row cannot see), and time kernel, plain version and, where one exists, a
     single PyTorch call for the same function (a yardstick only; the port
     never calls it), with TF/s for the attention kernels; #4 also at a
     serving prefill chunk (64 rows at offsets 65-126 into 2048 cache slots
     with 129-190 valid keys, its bound over the visible keys); the bf16
     attention kernel of #3, #4, #15 and #16 at its tile edges (T, S of 1,
     63, 64, 65, 500), every mask, a row of length 0, GQA 4, head_dim 128,
     the packed head-major and (B, T, H, D) layouts, both probe exponents,
     two runs bit-equal, 1e4 in every cache slot no row can see (the output
     must not move: the kernel stops at the last visible key), and a
     misaligned view that must raise; flash_attention's forward and backward kernels run in
     fp32 and bf16 on ragged lengths, a row of length 0, windows, the
     latency block, head_dim 128 and T of 1, 17, 64, 65, 128 and 500 (the
     bf16 kernels' tile edges), two runs bit-equal, with junk past the
     lengths, and are timed (with TF/s) at the decoder's and the encoder's
     training shapes;
     the split KV kernel of #8 and #11 in bf16 and fp32 at every length at
     its granule and split edges (0, 1, 15-17, 31-33, 63-65, 144, 255, 256
     of 256 slots), head_dim 64 and 128, GQA 1/4/8, T 1 and 3, windows 0/8/32,
     and at serving run (c)'s 2048-slot slab (129-190 keys), two runs
     bit-equal and 1e4 in every unseen slot moving nothing; #8 and
     #11 are timed at the flagship step and at serving run (c)'s 2048-slot
     slab (129-190 keys), beside the bound, SDPA and the recorded time of
     the one-block kernel they replace; the paged instances (#9, #12) at
     lengths on the page, granule and split edges (0-257 and 1900) in pages
     of 16, 48 and 256, head_dim 64 and 128, GQA 1/4/8, T 1 and 3, windows 0
     and 37, each within tolerance, bit-equal twice and unmoved by junk, and
     timed at the paged engine's shapes beside their cluster size, the
     one-block kernel's recorded time and #8 / #11 on the same lengths;
     ln_qkv_head_fused (#2) at the encoder's (4, 500, 768) and (1, 500,
     768) x (768, 2304) in heads of 64 (the tensor-core kernel), timed
     beside its bound, its plain version, torch.mm on the LN'd rows and the
     unfused four-call chain (yardsticks), and within 4 bf16 ulps and two
     calls bit-equal there and at T 1, a ragged (2, 77, 96) in heads of 32,
     whisper-large's (1, 1500, 1280) x (1280, 3840), an unaligned view and
     fp32 (both the CUDA-core kernel, fp32 within 1e-5);
     qkv_head_transpose is bit-equal twice in bf16 and fp32 at (4, 500,
     2304), (1, 500, 2304), T 1, a T its 4-row blocks leave a partial last
     block of, 3-row blocks forced and a ragged T with head_dim 128 (each
     call followed by a sync with a watchdog), and timed at B 1 and 4
     beside transpose(1, 2).contiguous();
     the three kernels no engine launches (as in the reference):
     ln_matmul_gelu (#6) at the encoder's fc1 at 4 requests and at one and
     whisper-large's (1, 1500, 1280) x (1280, 5120) (the tensor-core
     kernel), timed beside its bound, its plain version, torch.mm on the
     LN'd rows and the unfused three-call chain, and within 4 bf16 ulps and
     two calls bit-equal there and at T 1, a ragged (2, 77, 96) x (96, 384),
     an unaligned view and fp32 (both the CUDA-core kernel, fp32 within 1e-5
     of the largest output); attn_out_proj_residual (#7) at the encoder's
     out-projection at 4 requests and at one and whisper-large's (1, 20,
     1500, 64) x (20, 64, 1280) (the tensor-core kernel), timed beside the
     same yardsticks (torch.mm on the concatenated heads, the three-call
     chain), within 4 bf16 ulps and two calls bit-equal there and at T 1,
     T 501 (a tile straddles two batch rows), M 520, heads of 128, 32 heads
     of 64 into 2048, every tile and column-tile count forced, an unaligned
     view and fp32 (both the CUDA-core kernel); and decode_matmul on every
     Llama-3.2-1B decoder product
     with a bf16 and an int8 + scale weight (1, 4 and 32 rows, bf16 and
     fp32, two calls bit-equal, one device kernel a call), timed at 4 rows
     beside torch.mm (its factor printed), lora.py's w8a16 product and
     torch._weight_int8pack_mm; fused_layer_norm also at (1, 500, 768) bf16
     and (4, 500, 768) fp32 beside F.layer_norm, two calls bit-equal;
     #11 and #12 at the speculative verify forward of phase 11 (q (4, 9,
     32, 64), Hkv 8, 129-190 keys of a 2048-slot slab and of the same keys
     in shuffled pages of 256, a 72-slot tail with 0-18 written), bf16
     within 4 ulps of the plain versions, two runs bit-equal, timed beside
     the bound and SDPA (their own rows of the kernels line);
  3. small configs (a llama-family speech model and a gemma-3-style decoder
     with sliding windows): greedy tokens from the kernel paths on the card
     equal those of the plain paths on the CPU (fp32) for generate with the
     decode kernel, generate_fused, the segmented scan with its kernel, and
     the ServingEngine in slots and paged modes with both block attentions;
     and two KL train steps with an audio LoRA through the flash_attention
     kernels on the card against the same steps on the CPU; the multi-LoRA
     ServingEngine (text and audio adapters, fused encoder) in slots and
     paged modes, tokens equal to the CPU's with qkv_head_transpose
     launched; GenerationEngine(quantize="int8"): every int8 projection on
     the card against the CPU (w8a8 bit-equal), prefill logits within a
     relative RMS of 0.05 and 0.1 of the largest logit of the CPU's, beside
     two faults planted on the CPU, token agreement printed;
     encoder_attn_impl="flash" in a GenerationEngine and a paged
     ServingEngine: tokens equal to the CPU's, flash_attention's forward
     launched once per encoder layer per encoder call, #1-#3 not at all;
  4. the main paths at flagship widths (whisper-small encoder, Llama-3.2-1B
     decoder, random bf16 weights from a seed) on 4 requests of 10 s
     synthesized audio, each with every kernel's launch count set to 0
     just before it and checked just after:
       generate(decode_attn_impl="kernel")   12/12/12/16 + 496 decode_attention
       generate_fused (plain merged attention) 12/12/12/16
       prefill + segmented_decode_scan(attn_impl="kernel")
                                               12/12/12/16 + 496 segment_tail_attention
     then breaks the time of generate, generate_fused and the kernel scan
     down by phase and, through torch.profiler, by kernel, with #8's and
     #11's split-kernel device time per call (a one-block kernel in the
     trace fails the run);
  5. the ServingEngine at flagship widths: 8 greedy requests (10 s of audio
     in a 128-token prompt, 32 tokens each) on 4 slots, in three engines
     run in turn: paged with the segment kernel in decode blocks
     (paged_decode_attention + paged_segment_tail_attention), paged with the
     gathered view (paged_decode_attention + gather_pages), and slots with
     the segment kernel (decode_attention + segment_tail_attention). The
     launch counts are checked against the engine's own counters, and TTFT,
     throughput, the loop's dispatch and fetch time, peak memory and (for
     a traced second run of each) the device's busy share are printed, with
     #2's and #3 + #4's device time and launches and the split KV kernels'
     (#9 + #12, #9, #8 + #11) time and launches; a one-block KV kernel in a
     trace fails;
  6. the training step of the v0.6 recipe at flagship widths (KL
     distillation, projector + audio LoRA r 8 trainable, remat, chunked
     vocabulary, flash attention in both towers) on bench.py's batch of 8 x
     10 s audio: 72 forward and 28 backward flash_attention calls per step
     checked, loss, grad_norm, step time, samples/s, MFU, peak memory, the
     device's busy share, a kernel breakdown, and no host wait in a step;
     then one forward and backward of the KL loss through the bf16 flash
     kernels against the same call through _FlashPlain (loss within 2^-6,
     gradient norm within 2^-4, relative);
  7. multi-LoRA and int8 at flagship widths on phase 4's weights and batch
     (see _lora_int8_main_path): a paged ServingEngine with two v0.6-style
     adapters (24 fused_layer_norm, 12 qkv_head_transpose, 12
     attention_headmajor, 0 ln_qkv_head_fused per admission), an int8
     GenerationEngine (the same encoder counts per generate, TTFT, tok/s,
     weight bytes, tokens against phase 4's, and what w8a16's per-call cast
     of the int8 weight costs) and an int8 + multi-LoRA ServingEngine in
     slots mode (both serving engines traced as in phase 5), then the
     phase's time;
  8. the encoder-attention probes' entry point
     (ultravox_torch.scripts.profile_encoder_attn) at B 8, T = S = 1500, H
     20, D 64: every attn_v2 / attn_nt variant timed beside the production
     kernel and SDPA and held against its plain version at that shape, both
     probes' counters moved; then the script's time;
  9. a checkpoint of phase 4's weights (see _checkpoint_main_path):
     save_pretrained in one file and in two shards, each loaded onto the
     card bit-equal (bytes, write and load GB/s); phase 3's small config
     loaded from a diff checkpoint with bases by id (without them it must
     raise), and its ServingEngine's penalties, logit_bias, logprobs and
     seeded sampling on the card against the CPU; then 8 requests with
     every option (2 plain, 2 penalized and biased, 2 with logprobs, 2
     seeded at temperature 0.8) served from the loaded tree, tokens equal
     to an engine on phase 4's tree, launches checked (#9 in every single
     step, #12 in no step while such a request is active), seeded requests
     repeated alone, precomputed audio_embeds against audio, and TTFT,
     tok/s and the busy share beside phase 5 (a)'s;
 10. the voice path on phase 4's weights with 1 s latency blocks (see
     _voice_main_path): StreamingAudioEncoder on 10 s of speech against
     the batch block-causal encode (bf16 within a relative RMS of 2^-5,
     fp32 within 1e-4), the stream step, finalize and batch encode ms;
     the HTTP server (4 + 1 requests, one resampled from 24 kHz, plain
     and streamed) with TTFT, tok/s and launches checked, each request
     alone equal to submit; the voice WebSocket (two turns of 6 s paced
     at real time) through the streaming encoder (no launch of #1-#3),
     pause-to-first-token beside the batch path's TTFT, and the decode
     step with and without concurrent stream steps;
 11. the front doors and speculative decoding on phase 4's weights (see
     _front_doors_main_path and _spec_serving): a checkpoint directory with
     a tokenizer over all 128256 ids (built here with ``tokenizers``, a
     llama-3-style chat template written inline) read by the port's
     loader; UltravoxInference's infer (launches of #1-#4 and #8 as phase
     4's generate), infer_stream (TTFT), two conversation turns (the
     second prefills only its suffix) and one pipeline() call; the server
     built by api_server.build_api from argv with --spec-decode ngram
     --spec-k 8 (the attention flags left to "auto", which picks every
     kernel) on an ephemeral port, OpenAIInference plain and streamed
     equal to submit on the same engine; phase 5's traffic on slots and
     paged engines with the segment kernels, without speculation, with it
     (guard off: #11 / #12 at T = 9 in multi-round blocks, launches checked
     against the engine's counters) and with the default guard: tok/s,
     TTFT, accepted tokens a round a slot, autopauses, every run's tokens
     held to SPEC_MARGIN's rule at every position against a teacher-forced
     forward, and the requests equal to the run without speculation.

 12. the training loop at flagship width (see _train_loop_main_path):
     training/train.py::train on the port's copy of the v0.6 recipe (KL,
     audio LoRA r 8, remat, flash, vocab chunk 256, bf16) with
     TRAIN_LOOP_OVERRIDES (synthetic-asr, batch 8, 2 micro-steps an
     update, 3 updates, a checkpoint every 4 micro-steps, validation at 6):
     #13's launches checked, micro-step 1's loss against the plain
     versions, the output files, and a resumed second run whose restored
     state equals the first run's final state bit for bit; the loop's ms a
     micro-step beside the step alone, the data pipeline alone, the busy
     share over two traced micro-steps, checkpoint write / restore /
     validation ms.

 13. the wav2vec2 tower (see _w2v_main_path), random bf16 weights from the
     seed, 4 requests of synthesized speech of 10, 7.3, 4.1 and 1 s: (a)
     the published large-lv60 and base towers alone at full width, bf16
     against the same weights in fp32 on the card (W2V_RMS_TOL), each row
     of the layer variant alone against its padded row, ms per call and the
     device time of the conv stack, the positional conv and the layers;
     (b) tiny wav2vec2 + llama models in both variants, greedy tokens on
     the card (kernels) equal to the CPU's (plain) for generate,
     generate_fused and the ServingEngine in slots and paged modes with
     sample buckets; (c) GenerationEngine(decode_attn_impl="kernel") with
     the large tower under the flagship decoder: #4 16, #8 496, #1-#3 and
     #13 none, TTFT and tok/s, an int8 engine that leaves the tower as it
     was; (d) a paged ServingEngine with #9 + #12 on phase 5's traffic,
     launches against its counters, TTFT and tok/s; (e) save_pretrained
     loaded back bit for bit, and a Wav2Vec2ForCTC-layout tower file read
     through convert_audio_tower_checkpoint; (f) three KL train steps
     (projector trainable) with #13's launches in the decoder only, the
     loss and gradient norm against _FlashPlain, step ms and peak memory.

 14. several processes, one a card (see _multiprocess_main_path): as many
     ranks of this script as the machine has cards, each started with
     torchrun's environment, NCCL on cuda:LOCAL_RANK: (a) train() on phase
     12's run-1 config with mesh_fsdp -1 through parallel/ (a checkpoint
     at micro-step 4 through the gather), #13's launches checked, every
     logged loss, grad_norm and the validation loss held against phase
     12's (bit for bit at world 1), each step call's ms beside phase 12's
     step alone; (b) that checkpoint resumed in this process without a
     process group, its next step equal to the run's; (c) the eval CLI's
     main() on a flagship checkpoint (16 synthetic-asr samples, batches of
     8, greedy), #1-#4 and #8 checked per generate call, rank 0's two
     JSON files with 16 samples in index order, samples/s. The world size
     is printed first. ``--phases 12,14`` runs the build and these two
     phases alone, without a result line.
 15. the tensor axis (see _tensor_main_path): two ranks of this script on
     the one card over a gloo group, mesh data 1 x fsdp 1 x tensor 2, the
     model of v0.6_qwen3_32b_tpu.yaml (Qwen3-32B widths, 8 layers;
     whisper-large-v3-turbo's encoder): (a) 3 KL train steps, the ranks'
     losses bit-equal and within bf16 tolerance of one process's, #13 at
     the local heads; (b) ServingEngine(mesh=) slots, paged and both with
     speculative decoding, 4 requests of 10 s x 32 tokens, both ranks'
     tokens identical, launches checked at the local shapes, the first
     decode step's logits within a relative RMS of one process's, token
     agreement, TTFT and tok/s beside one process's; each rank's held
     bytes, its slots engine's bytes, the collectives' MB a step and the
     gathers that made a vocabulary leaf whole, which must be 0.
     ``--phases 15`` runs the build and this phase alone, without a result
     line; ``--phases 15 --baseline DIR`` runs the package of another
     checkout (DIR, its root) in two ranks first and prints both layouts.
 16. the pipe axis (see _pipe_main_path): two ranks of this script on the
     one card over a gloo group, mesh data 1 x fsdp 1 x tensor 1 x pipe 2,
     the model of v0.6_llama3_70b_pipe_tpu.yaml (Llama-3.3-70B widths, 8
     layers, 4 a stage; whisper-large-v3-turbo's encoder): one validation
     batch and 3 KL train steps of 8 rows in 4 microbatches (the GPipe
     schedule of parallel/pipeline.py, 5 steps a pass); the
     ranks' losses, grad norms and validation sums equal and within bf16
     tolerance of one process's; #13 on each rank's encoder (64 forward and
     32 x 3 backward launches a step, 32 in the validation batch), no other
     kernel; the GB each rank holds, its peak and its step ms beside one
     process's, and a fourth step traced (the card's ms by kernel kind).
     ``--phases 16`` runs the build and this phase alone,
     without a result line.
 17. run_serving_eval and the host tools (see _serving_eval_main_path), on
     phase 4's weights remade from the seed: the flagship published with
     save_pretrained(include_code=True) (the hub files and auto_map
     checked), served by run_serving_eval.start_server and scored over
     HTTP (16 synthetic-asr samples x 32 tokens, a finite score, launches
     against the engine's counters, samples/s), averaged with a second
     tree (seed 1) and loaded back (sampled tensors bit-equal to the bf16
     of the fp64 mean, generate runs), and the projector up-projected to a
     4096-wide embedding on the card against the CPU. ``--phases 17``
     runs the build and this phase alone, without a result line.

Each phase prints its seconds. Phases 4-7 also hold ln_matmul_gelu, attn_out_proj_residual,
decode_matmul, attn_v2 and attn_nt at 0 launches: no engine calls them.

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and as its last line {"ok": true, "device": {...}}. Exits non-zero
without a result when there is no CUDA card or the package is missing.
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
SEED = 0


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _synced(label: str, seconds: float = 30.0) -> None:
    """Wait until the card has run everything queued so far. A kernel that
    waits on a barrier for bytes that never arrive would hang the run: after
    ``seconds`` this fails it and ends the process instead."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > seconds:
            print(f"chip_smoke: FAIL: {label}: the card has not finished after {seconds} s",
                  file=sys.stderr, flush=True)
            os._exit(1)
        time.sleep(1e-4)


def _time_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """Mean ms per call between CUDA events. ``queued``: the card first
    sleeps while the host enqueues every call, so the events time the
    card's work alone; without it the time includes the host's dispatch
    whenever that is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, kernel: str, iters: int = 20):
    """From a torch.profiler trace of ``iters`` calls of fn: (device ms per
    launch of the device kernel named ``kernel``, its launches per call,
    names of any other device work fn queued). The trace may drop events,
    so the time is the mean over the launches it did record, and the count
    may come out below 1; it never invents a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    mine = [e for e in evs if kernel in e.key]
    others = [e.key for e in evs if kernel not in e.key]
    n = sum(e.count for e in mine)
    ms = sum(e.self_device_time_total for e in mine) / n / 1e3 if n else None
    return ms, n / iters, others


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes: int, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flagship_config(tc):
    """whisper-small encoder + Llama-3.2-1B decoder widths, as the JAX
    package's flagship (its __graft_entry__._flagship_config)."""
    return tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(
            num_mel_bins=80, d_model=768, num_layers=12, num_heads=12,
            ffn_dim=3072, max_source_positions=1500,
        ),
        text_config=tc.DecoderConfig(
            arch="llama", vocab_size=128256, hidden_size=2048,
            intermediate_size=8192, num_layers=16, num_heads=32,
            num_kv_heads=8, head_dim=64, rope_theta=500000.0,
            rms_norm_eps=1e-5, tie_word_embeddings=True,
            max_position_embeddings=8192,
        ),
        hidden_size=3072,
        projector_ln_mid=True,
    )


def _audio(n: int, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """(n, samples) chirp + harmonics + noise at 16 kHz."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    out = []
    for i in range(n):
        f0 = 120.0 + 40.0 * i
        chirp = 0.3 * np.sin(2 * np.pi * (f0 + 150.0 * t) * t)
        harm = sum(0.1 / h * np.sin(2 * np.pi * h * f0 * t) for h in (2, 3, 4))
        out.append(chirp + harm + 0.01 * rng.standard_normal(t.size))
    return np.stack(out).astype(np.float32)


def _batch(cfg, mel: torch.Tensor, prompt_len: int, rng: np.random.Generator):
    """Collated batch: each row's audio spliced at position 4 of the prompt."""
    from ultravox_torch.models.projector import num_audio_tokens

    n = mel.shape[0]
    mel_len = mel.shape[-1]
    ntok = num_audio_tokens(mel_len, cfg.audio_token_compression)
    ids = rng.integers(1, cfg.vocab_size, (n, prompt_len)).astype(np.int64)
    return {
        "input_ids": ids,
        "attention_mask": np.ones((n, prompt_len), np.int64),
        "audio_values": mel.cpu().numpy(),
        "audio_lens": np.full((n,), mel_len, np.int32),
        "audio_token_len": np.full((n,), ntok, np.int32),
        "audio_token_start_idx": np.full((n,), 4, np.int32),
        "audio_chunk_batch_idx": np.arange(n, dtype=np.int32),
    }


def _bf16_tol(ref) -> float:
    """The kernels sum in another order than the plain versions, so bf16
    outputs may differ by a few units in the last place (2^-8 relative):
    4 ulps of the largest output, with no absolute floor."""
    return 4 * 2.0**-8 * float(ref.abs().max())


# A bound on the relative RMS error of a bf16 flash_attention output or
# gradient: 2^-10, a quarter of what every element off by one ulp would
# give (most elements agree bit for bit). It stands beside _bf16_tol, which
# one large entry (a causal row 0 that copies v[0]) can make loose for the
# typical entry.
FLASH_RMS_TOL = 2.0**-10


def _rel_rms(out, ref) -> float:
    """||out - ref|| / ||ref|| over every element, in fp32."""
    ref = ref.float()
    return float((out.float() - ref).norm() / ref.norm().clamp(min=1e-30))


def _recorder(rows, tol):
    """record(...): hold one kernel against its plain version, time kernel,
    plain version and library call, check the trace, append its row."""

    def record(name, kernel, source, replaces, out, ref, k_fn, p_fn, lib_fn, nbytes, flops, peak,
               calls=1, extra=None):
        """``calls``: device kernels one call launches (their names all hold
        ``kernel``); ``device_ms`` is then the trace's time per call."""
        err = float((out.float() - ref.float()).abs().max())
        t = tol(ref)
        bound_ms, bound_by = _bound(nbytes, flops, peak)
        device_ms, per_call, others = _device_ms(k_fn, kernel)
        if device_ms is not None:
            device_ms *= calls
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "tol": t,
            "ms": _time_ms(k_fn), "plain_ms": _time_ms(p_fn),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _time_ms(lib_fn) if lib_fn is not None else None,
            "device_ms": device_ms, "device_kernels_per_call": per_call,
            "wrapper_ms": _time_ms(k_fn, queued=False), **(extra or {}),
        }
        print(f"kernel {name}: max_abs_err {err:.3g} (tol {t:.3g}) ms {row['ms']:.4f} "
              f"(trace {device_ms} in {per_call:g} kernels/call; with host dispatch "
              f"{row['wrapper_ms']:.4f}) plain_ms {row['plain_ms']:.4f} "
              f"library_ms {row['library_ms']} bound_ms {bound_ms:.5f} ({bound_by})", flush=True)
        if not err <= t:
            _fail(f"{name} disagrees with its plain version: {err} > {t}")
        # the wrapper must queue its kernel and nothing else (no casts or
        # copies); a trace that dropped events can only undercount
        if per_call > calls or others:
            _fail(f"{name}: the trace shows {per_call:g} {kernel} launches per call "
                  f"and other device work {sorted(set(others))}, expected {calls} and none")
        rows.append(row)
        return row

    return record


def _rate(row, flops):
    """TF/s of the kernel (the reference's flops) and its factor to the
    library call, into its row."""
    row["tflops"] = flops / row["ms"] / 1e9
    row["library_factor"] = row["ms"] / row["library_ms"]
    print(f"kernel {row['name']}: {row['tflops']:.2f} TF/s, {row['library_factor']:.2f}x "
          f"the library's {row['library_ms']:.4f} ms", flush=True)


def _fused_plain(fa, q, k, v, lens, offs, causal=True, latency_block=0):
    """fused_attention's plain version on (B, T, H, D) tensors."""
    return fa.attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lens, offs,
        scale=q.shape[-1] ** -0.5, causal=causal, latency_block=latency_block).transpose(1, 2)


# #2's edge cases: label, (B, T, D, C, head_dim), dtype, element offset of x
# in its storage (1: a view the 16-byte copies cannot take)
LN_QKV_EDGES = (
    ("T 1", (4, 1, 768, 2304, 64), torch.bfloat16, 0),
    ("ragged (2,77,96) heads of 32", (2, 77, 96, 288, 32), torch.bfloat16, 0),
    ("whisper-large (1,1500,1280)", (1, 1500, 1280, 3840, 64), torch.bfloat16, 0),
    ("a tensor-2 rank of whisper-large (1,500,1280) -> 1920", (1, 500, 1280, 1920, 64),
     torch.bfloat16, 0),
    ("unaligned view (2,77,768)", (2, 77, 768, 2304, 64), torch.bfloat16, 1),
    ("fp32 (4,500,768)", (4, 500, 768, 2304, 64), torch.float32, 0),
)


def _check_ln_qkv_head(fa, x, s, b, s_bf, b_bf, Dh, dev, g):
    """Phase 2, #2: the tensor-core kernel at the encoder's shapes, at 4
    requests and at 1 (a serving admission), against its plain version
    (4 bf16 ulps of the largest output), two calls bit-equal, timed beside
    its bound, torch.mm on the LN'd rows (the product alone) and the
    unfused four-call chain; then LN_QKV_EDGES, each routed as _plan says
    (the unaligned view and fp32 to the CUDA-core kernel, fp32 within
    1e-5) and bit-equal twice. Returns the kernel's row."""
    from ultravox_torch.scripts.compare_kernels import ln_qkv_chain

    bf = torch.bfloat16
    B, T, D = x.shape
    C = 3 * D
    w = (0.02 * torch.randn((D, C), generator=g, device=dev)).to(bf)
    wb = (0.02 * torch.randn((C,), generator=g, device=dev)).to(bf)
    rec = _recorder([], _bf16_tol)
    shapes, main = {}, None
    for label, xs in (("(4,500,768)", x), ("(1,500,768)", x[:1].contiguous())):
        out, again = fa.ln_qkv_head_fused(xs, s, b, w, wb, Dh), fa.ln_qkv_head_fused(xs, s, b, w, wb, Dh)
        ref = fa.ln_qkv_head_plain(xs, s, b, w, wb, Dh)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            _fail(f"ln_qkv_head_fused {label}: two calls differ")
        h = fa._layer_norm_rounded(xs, s, b, 1e-5).view(-1, D)
        row = rec(
            f"ln_qkv_head_fused {label}", "ln_qkv_head_mma_kernel",
            "ultravox_torch/ops/kernels/csrc/ln_qkv_head.cu",
            "ultravox_tpu/ops/pallas/fused_attention.py:290", out, ref,
            lambda xs=xs: fa.ln_qkv_head_fused(xs, s, b, w, wb, Dh),
            lambda xs=xs: fa.ln_qkv_head_plain(xs, s, b, w, wb, Dh),
            None, _nbytes(xs, s, b, w, wb, out), 2.0 * xs.shape[0] * T * D * C, BF16_FLOPS,
            extra={"torch_mm_ms": _time_ms(lambda h=h: torch.mm(h, w)),
                   "chain_ms": _time_ms(lambda xs=xs: ln_qkv_chain(xs, s_bf, b_bf, w, wb, Dh)),
                   "plan": fa._plan(True, xs.shape[0] * T, D, C, Dh, [0])._asdict()},
        )
        shapes[label] = {k: row[k] for k in ("ms", "device_ms", "wrapper_ms", "plain_ms", "bound_ms",
                                             "torch_mm_ms", "chain_ms", "max_abs_err", "plan")}
        print(f"ln_qkv_head_fused {label}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} "
              f"({row['ms'] / row['bound_ms']:.1f}x), torch.mm {row['torch_mm_ms']:.4f}, chain "
              f"{row['chain_ms']:.4f} ({row['ms'] / row['chain_ms']:.2f}x); plan {row['plan']}; "
              f"two calls bit-equal", flush=True)
        main = main or row
    edges = {}
    gq = torch.Generator(device=dev).manual_seed(SEED + 2)
    for label, (Bq, Tq, Dq, Cq, Dhq), dtype, offset in LN_QKV_EDGES:
        base = torch.randn((Bq * Tq * Dq + offset,), generator=gq, device=dev).to(dtype)
        xq = base[offset:].view(Bq, Tq, Dq)
        sq = 1 + 0.1 * torch.randn((Dq,), generator=gq, device=dev)
        bq = 0.1 * torch.randn((Dq,), generator=gq, device=dev)
        wq = (0.05 * torch.randn((Dq, Cq), generator=gq, device=dev)).to(dtype)
        wbq = (0.05 * torch.randn((Cq,), generator=gq, device=dev)).to(dtype)
        mma = fa._plan(dtype == bf, Bq * Tq, Dq, Cq, Dhq, [xq.data_ptr(), sq.data_ptr(),
                                                          bq.data_ptr(), wq.data_ptr(), 0]).mma
        if mma != (dtype == bf and offset == 0):
            _fail(f"ln_qkv_head_fused {label}: routed to the {'tensor' if mma else 'CUDA'} cores")
        out = fa.ln_qkv_head_fused(xq, sq, bq, wq, wbq, Dhq)
        again = fa.ln_qkv_head_fused(xq, sq, bq, wq, wbq, Dhq)
        ref = fa.ln_qkv_head_plain(xq, sq, bq, wq, wbq, Dhq)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = _bf16_tol(ref) if dtype == bf else 1e-5
        edges[label] = {"max_abs_err": err, "tol": tol, "tensor_cores": mma}
        print(f"ln_qkv_head_fused {label}: max_abs_err {err:.3g} (tol {tol:.3g}), "
              f"{'tensor' if mma else 'CUDA'} cores, two calls bit-equal "
              f"{torch.equal(out, again)}", flush=True)
        if not (err <= tol and torch.equal(out, again)):
            _fail(f"ln_qkv_head_fused {label}: {err} > {tol} or two calls differ")
    return dict(main, name="ln_qkv_head_fused", shapes=shapes, edge_cases=edges)


# #5's cases: label, (B, T, G, head_dim), dtype, rows of T a block owns
# (None: as the plan picks). 36 heads of 64 at four requests and at one, a
# single frame, a T the plan's 4-row blocks leave a partial last block of,
# 3-row blocks forced, fp32 heads of 128 at a ragged T, fp32 at both B.
TRANSPOSE_EDGES = (
    ("B 4", (4, 500, 36, 64), torch.bfloat16, None),
    ("B 1", (1, 500, 36, 64), torch.bfloat16, None),
    ("T 1", (1, 1, 36, 64), torch.bfloat16, None),
    ("T 501 (T % 4 == 1)", (4, 501, 36, 64), torch.bfloat16, None),
    ("T 77 in 3-row blocks", (2, 77, 36, 64), torch.bfloat16, 3),
    ("fp32 (2,77) head_dim 128", (2, 77, 6, 128), torch.float32, None),
    ("fp32 B 4", (4, 500, 36, 64), torch.float32, None),
    ("fp32 B 1", (1, 500, 36, 64), torch.float32, None),
)


def _check_kernels(fa, ln_mod, dev):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    B, T, D, H, Dh = 4, 500, 768, 12, 64  # 10 s audio: 1000 mel frames -> 500
    rows = []
    record = _recorder(rows, _bf16_tol)

    # 1. LayerNorm of the encoder FFN; scale and bias are fp32, as
    # fuse_encoder_inference_params stores them
    x = torch.randn((B, T, D), generator=g, device=dev).to(bf)
    s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
    b = 0.1 * torch.randn((D,), generator=g, device=dev)
    s_bf, b_bf = s.to(bf), b.to(bf)
    ln_row = None
    ln_shapes = {}
    ln_rec = _recorder([], lambda ref: _bf16_tol(ref) if ref.dtype == bf else 1e-5)
    for label, xs in (("(4,500,768) bf16", x), ("(1,500,768) bf16", x[:1].contiguous()),
                      ("(4,500,768) fp32", x.float())):
        out, again = ln_mod.fused_layer_norm(xs, s, b), ln_mod.fused_layer_norm(xs, s, b)
        ref = ln_mod.layer_norm_plain(xs, s, b)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            _fail(f"fused_layer_norm {label}: two calls differ")
        s_x, b_x = (s_bf, b_bf) if xs.dtype == bf else (s, b)
        row = ln_rec(
            f"fused_layer_norm {label}", "layer_norm_warp_kernel",
            "ultravox_torch/ops/kernels/csrc/layer_norm.cu",
            "ultravox_tpu/ops/pallas/layer_norm.py:38", out, ref,
            lambda xs=xs: ln_mod.fused_layer_norm(xs, s, b),
            lambda xs=xs: ln_mod.layer_norm_plain(xs, s, b),
            lambda xs=xs, s_x=s_x, b_x=b_x: F.layer_norm(xs, (D,), s_x, b_x, 1e-5),
            _nbytes(xs, s, b, out), 8.0 * xs.numel(), FP32_FLOPS,
        )
        ln_shapes[label] = {k_: row[k_] for k_ in ("ms", "device_ms", "wrapper_ms", "plain_ms",
                                                    "library_ms", "bound_ms", "max_abs_err")}
        print(f"fused_layer_norm {label}: {row['ms']:.4f} ms, {row['ms'] / row['library_ms']:.2f}x "
              f"F.layer_norm's {row['library_ms']:.4f}; two calls bit-equal", flush=True)
        ln_row = ln_row or row
    rows.append(dict(ln_row, name="fused_layer_norm", shapes=ln_shapes))

    # 2. LN -> qkv -> head-major
    rows.append(_check_ln_qkv_head(fa, x, s, b, s_bf, b_bf, Dh, dev, g))

    # 3. head-major encoder attention (all 500 keys valid at 10 s). Unit
    # normal q/k/v give logits of unit spread, so a wrong scale or mask
    # moves the output by far more than the tolerance.
    qkv_t = torch.randn((B, 3 * H, T, Dh), generator=g, device=dev).to(bf)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    q3, k3, v3 = qkv_t[:, :H], qkv_t[:, H:2 * H], qkv_t[:, 2 * H:]
    att = fa.attention_headmajor(qkv_t, lens, n_heads=H)
    ref = fa.attention_plain(q3, k3, v3, lens, scale=Dh**-0.5)
    torch.cuda.synchronize()
    keymask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    flops = 4.0 * B * H * T * T * Dh
    row = record(
        "attention_headmajor", "attention_mma_kernel",
        "ultravox_torch/ops/kernels/csrc/attention.cu",
        "ultravox_tpu/ops/pallas/fused_attention.py:493", att, ref,
        lambda: fa.attention_headmajor(qkv_t, lens, n_heads=H),
        lambda: fa.attention_plain(q3, k3, v3, lens, scale=Dh**-0.5),
        lambda: F.scaled_dot_product_attention(q3, k3, v3, attn_mask=keymask),
        _nbytes(qkv_t, lens, att), flops, BF16_FLOPS,
    )
    _rate(row, flops)

    # 4. causal prefill of a 128-token prompt into a 256-slot cache slab;
    # then a serving prefill chunk: 64 rows at offsets 65-126 into the
    # engine's 2048-slot scratch with 129-190 valid keys, where the kernel
    # stops at the last visible key (its row nests in the first's)
    def prefill_row(name, B, Tp, S, lens, offsets):
        Hq, Hkv = 32, 8
        q = torch.randn((B, Tp, Hq, Dh), generator=g, device=dev).to(bf)
        k = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
        v = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
        plen = torch.tensor(lens, dtype=torch.int32, device=dev)
        offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
        att = fa.fused_attention(q, k, v, plen, offs, causal=True, scale=Dh**-0.5)
        ref = _fused_plain(fa, q, k, v, plen, offs)
        torch.cuda.synchronize()
        qh = q.transpose(1, 2)
        kh = k.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
        vh = v.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
        cols = torch.arange(S, device=dev)
        rows_pos = offs[:, None] + torch.arange(Tp, device=dev)[None]
        pmask = ((cols[None, None, :] <= rows_pos[:, :, None])
                 & (cols[None, None, :] < plen[:, None, None]))
        pairs = int(pmask.sum())  # visible (query, key) pairs of this run, per head
        # keys any row can see: below both the valid length and the last
        # row's position; the cache slots past them need not be read
        keys = int(torch.minimum(plen, offs + Tp).clamp(max=S).sum())
        kv_bytes = 2 * keys * Hkv * Dh * k.element_size()
        pmask = pmask[:, None]
        flops = 4.0 * Hq * pairs * Dh
        rec = record if name == "fused_attention" else _recorder([], _bf16_tol)
        row = rec(
            name, "attention_mma_kernel", "ultravox_torch/ops/kernels/csrc/attention.cu",
            "ultravox_tpu/ops/pallas/fused_attention.py:124", att, ref,
            lambda: fa.fused_attention(q, k, v, plen, offs, causal=True, scale=Dh**-0.5),
            lambda: _fused_plain(fa, q, k, v, plen, offs),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=pmask),
            _nbytes(q, att, plen, offs) + kv_bytes, flops, BF16_FLOPS,
            extra={"shape": f"q ({B},{Tp},{Hq},{Dh}), kv ({B},{S},{Hkv},{Dh}), keys {lens}, "
                            f"offsets {offsets}, causal"})
        _rate(row, flops)
        return row

    row = prefill_row("fused_attention", B, 128, 256, [128] * B, [0] * B)
    serving = prefill_row("fused_attention (serving chunk)", B, 64, 2048, [129, 150, 170, 190],
                          [65, 86, 106, 126])
    row["serving_shape"] = {k_: serving[k_] for k_ in (
        "shape", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "device_ms", "wrapper_ms", "tflops", "library_factor")}

    # 5. head-major relayout of the fused encoder's int8 / LoRA q/k/v
    # product: bit-equal to its plain version, twice, at TRANSPOSE_EDGES (each
    # call followed by a watchdog sync: a barrier count above the bytes its
    # copies move would hang); timed at B 1 (one serving admission) with the
    # B 4 time (int8 generate) beside it
    from ultravox_torch.scripts.compare_kernels import forced

    G = 3 * H
    transpose_edges = {}
    for label, (Bq, Tq, Gq, Dq), dtype, forced_rows in TRANSPOSE_EDGES:
        qkv = torch.randn((Bq, Tq, Gq * Dq), generator=g, device=dev).to(dtype)
        with forced("_transpose_plan", **({} if forced_rows is None else {"rows": forced_rows})):
            out = fa.qkv_head_transpose(qkv, Dq)
            _synced(f"qkv_head_transpose {label}")
            again = fa.qkv_head_transpose(qkv, Dq)
            _synced(f"qkv_head_transpose {label}")
            used = fa._transpose_plan(Bq, Tq, Gq, Dq * qkv.element_size(), fa._build.sm_count(0))
        ref = fa.qkv_head_transpose_plain(qkv, Dq)
        equal = torch.equal(out, ref) and torch.equal(again, ref)
        transpose_edges[label] = {"bit_equal_twice": equal, "plan": used._asdict()}
        print(f"check qkv_head_transpose {label} {str(dtype)[6:]}: bit-equal twice {equal}; "
              f"plan {used._asdict()}", flush=True)
        if not equal:
            _fail(f"qkv_head_transpose {label} {dtype} differs from its plain version")
    # Each timed call reads an input and writes an output that the previous
    # 31 calls did not touch (the 50 MB L2 holds a B 4 input and output), so
    # the times are HBM times, comparable with the bound.
    exact = _recorder(rows, lambda ref: 0.0)  # a copy: bit-equal or wrong
    times = {}
    for Bq in (4, 1):
        inputs = [torch.randn((Bq, T, G * Dh), generator=g, device=dev).to(bf) for _ in range(32)]
        qkv = inputs[0]
        out = fa.qkv_head_transpose(qkv, Dh)
        ref = fa.qkv_head_transpose_plain(qkv, Dh)
        torch.cuda.synchronize()
        nxt = itertools.cycle(inputs).__next__
        keep = collections.deque(maxlen=len(inputs)).append
        plan = fa._transpose_plan(Bq, T, G, Dh * 2, fa._build.sm_count(0))._asdict()
        args = ("qkv_head_transpose", "qkv_head_transpose_kernel",
                "ultravox_torch/ops/kernels/csrc/qkv_head_transpose.cu",
                "ultravox_tpu/ops/pallas/fused_attention.py:258", out, ref,
                lambda: keep(fa.qkv_head_transpose(nxt(), Dh)),
                lambda: keep(fa.qkv_head_transpose_plain(nxt(), Dh)),
                lambda: keep(nxt().view(Bq, T, G, Dh).transpose(1, 2).contiguous()),
                _nbytes(qkv, out), 0.0, BF16_FLOPS)
        if Bq == 4:
            r = exact(*args)
            times = {f"{k}_b4": r[k] for k in ("ms", "device_ms", "wrapper_ms", "plain_ms",
                                               "library_ms", "bound_ms")}
            times["plan_b4"] = plan
            rows.pop()
        else:
            exact(*args, extra=dict(times, plan=plan, edge_cases=transpose_edges))
    return rows


# The bf16 attention kernel of #3, #4, #15 and #16 (csrc/attention_mma.cuh):
# name, B, Tq, S, H, Hkv, head_dim, lengths, row offsets, causal, latency
# block. Tq and S at its tile edges (1, 63, 64, 65, 500), every mask, a row
# of length 0, GQA 4, and the serving prefill chunk into 2048 slots.
ATTN_CASES = (
    ("T1 S1", 2, 1, 1, 4, 4, 64, None, None, False, 0),
    ("T63 S63 lengths", 2, 63, 63, 4, 4, 128, [63, 20], None, False, 0),
    ("T64 S64 latency 16", 2, 64, 64, 4, 4, 64, [64, 33], None, False, 16),
    ("T65 S65 causal gqa 4", 2, 65, 65, 8, 2, 128, None, None, True, 0),
    ("T500 S500 latency 16 ragged", 3, 500, 500, 4, 4, 64, [500, 311, 1], None, False, 16),
    ("T65 S500 zero-length row", 2, 65, 500, 4, 4, 128, [0, 500], None, False, 0),
    ("T63 S500 causal offsets gqa 4", 2, 63, 500, 8, 2, 64, [200, 463], [137, 400], True, 0),
    ("serving T64 S2048", 2, 64, 2048, 32, 8, 64, [129, 190], [65, 126], True, 0),
    ("serving T64 S2048 head_dim 128", 2, 64, 2048, 8, 2, 128, [129, 190], [65, 126], True, 0),
    # a tensor-2 rank of phase 15: whisper-large's 10 of 20 heads, Qwen3-32B's
    # 32 of 64 query heads over 4 of 8 KV heads of 128 at a serving chunk
    ("tensor 2 encoder T500 10 heads", 1, 500, 500, 10, 10, 64, None, None, False, 0),
    ("tensor 2 prefill T64 S1024 32/4 heads of 128", 2, 64, 1024, 32, 4, 128, [129, 190],
     [65, 126], True, 0),
)


def _check_attention(fa, eap, dev):
    """Phase 2, continued: the bf16 attention kernel against its plain
    versions in every case of ATTN_CASES, through each entry point whose
    layout the case fits: fused_attention ((B, T, H, D) against (B, S, Hkv,
    D) cache views), attention_headmajor (the packed (B, 3H, T, D) array,
    non-causal, T = S) and both probes (non-causal, both exponents). Each
    within 4 bf16 ulps of max|ref| and a relative RMS of 2^-10, finite, two
    runs bit-equal; 1e4 in every cache slot no row can see leaves the
    serving chunk's output bit for bit (the kernel stops at the last visible
    key); a misaligned bf16 view raises ValueError."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf = torch.bfloat16

    def close(label, fn, plain):
        out, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = _bf16_tol(ref)
        rms = _rel_rms(out, ref)
        print(f"check attention {label}: max_abs_err {err:.3g} (tol {tol:.3g}), rel_rms "
              f"{rms:.3g} (tol {FLASH_RMS_TOL:.3g}), two runs bit-equal "
              f"{torch.equal(out, again)}", flush=True)
        if not (err <= tol and rms <= FLASH_RMS_TOL and torch.isfinite(out).all()):
            _fail(f"attention {label} disagrees with its plain version: {err} > {tol} or "
                  f"rel_rms {rms} > {FLASH_RMS_TOL}")
        if not torch.equal(out, again):
            _fail(f"attention {label}: two runs differ")

    def ints(v):
        return torch.tensor(v, dtype=torch.int32, device=dev) if v is not None else None

    for name, B, Tq, S, H, Hkv, D, lengths, offsets, causal, lb in ATTN_CASES:
        r = lambda *shape: torch.randn(shape, generator=g, device=dev).to(bf)  # noqa: E731
        q, k, v = r(B, Tq, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D)
        lens, offs = ints(lengths), ints(offsets)
        kw = dict(causal=causal, latency_block=lb)
        close(f"fused_attention {name}", lambda: fa.fused_attention(q, k, v, lens, offs, **kw),
              lambda: _fused_plain(fa, q, k, v, lens, offs, **kw))
        if Tq == S and H == Hkv and not causal and offsets is None:
            qkv = r(B, 3 * H, Tq, D)
            hl = lens if lens is not None else ints([S] * B)
            close(f"attention_headmajor {name}",
                  lambda: fa.attention_headmajor(qkv, hl, n_heads=H, latency_block=lb),
                  lambda: fa.attention_plain(qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:], hl,
                                             scale=D**-0.5, latency_block=lb))
        if H == Hkv and not causal and offsets is None and lb == 0:
            for probe in ("attn_v2", "attn_nt"):
                for exp in (torch.float32, bf):
                    fn = getattr(eap, probe)
                    close(f"{probe} {name} exp {str(exp)[6:]}",
                          lambda: fn(q, k, v, lens, scale=D**-0.5, block_q=Tq, exp_dtype=exp),
                          lambda: eap.attn_probe_plain(q, k, v, lens, scale=D**-0.5,
                                                       exp_dtype=exp))
        if name.startswith("serving"):
            out = fa.fused_attention(q, k, v, lens, offs, **kw)
            past = torch.arange(S, device=dev)[None, :] >= lens[:, None].long()
            jk, jv = k.clone(), v.clone()
            jk[past], jv[past] = 1e4, 1e4
            junk = fa.fused_attention(q, jk, jv, lens, offs, **kw)
            torch.cuda.synchronize()
            print(f"check attention {name}: 1e4 in every unseen slot moves the output by "
                  f"{float((out.float() - junk.float()).abs().max())}", flush=True)
            if not torch.equal(out, junk):
                _fail(f"attention {name} reads cache slots past the visible keys")
    wide = torch.randn((2, 8, 2, 68), generator=g, device=dev).to(bf)[..., :64]
    shifted = torch.zeros(2 * 8 * 64 + 1, device=dev, dtype=bf)[1:].view(2, 8, 1, 64)
    whole = torch.zeros((2, 8, 1, 64), device=dev, dtype=bf)
    for what, fn in (("strides of 136 bytes", lambda: fa.fused_attention(wide, wide, wide)),
                     ("a base 2 bytes past a 16-byte boundary",
                      lambda: eap.attn_nt(shifted, whole, whole, scale=0.125, block_q=8))):
        try:
            fn()
        except ValueError as e:
            print(f"check attention: {what} raises ValueError ({e})", flush=True)
        else:
            _fail(f"attention: {what} did not raise")


# Llama-3.2-1B's decoder products, (K, N) of each weight a decode step reads
DECODE_PRODUCTS = {
    "qkv_proj": (2048, 3072), "o_proj": (2048, 2048), "gateup_proj": (2048, 16384),
    "down_proj": (8192, 2048), "lm_head": (2048, 128256),
}
L2_BYTES = 50 * 2**20  # H100 L2


# #6's cases: label, (B, T, D, F), dtype, element offset of x in its storage
# (1: a view the 16-byte copies cannot take). Timed: the encoder's fc1 at 4
# requests and at one, and whisper-large's FFN (the JAX note's bench shape).
GELU_TIMED = (("fc1 (4,500,768)", (4, 500, 768, 3072)), ("fc1 (1,500,768)", (1, 500, 768, 3072)),
              ("whisper-large (1,1500,1280)", (1, 1500, 1280, 5120)))
GELU_EDGES = (
    ("T 1", (4, 1, 768, 3072), torch.bfloat16, 0),
    ("ragged (2,77,96) x (96,384)", (2, 77, 96, 384), torch.bfloat16, 0),
    ("unaligned view (2,77,768)", (2, 77, 768, 3072), torch.bfloat16, 1),
    ("fp32 (4,500,768)", (4, 500, 768, 3072), torch.float32, 0),
)


def _check_ln_matmul_gelu(fa, dev, g):
    """Phase 2, #6: the tensor-core kernel at GELU_TIMED against its plain
    version (4 bf16 ulps of the largest output), two calls bit-equal, timed
    beside its bound, torch.mm on the LN'd rows (the product alone) and the
    unfused three-call chain (yardsticks: no single call computes it); then
    GELU_EDGES, each routed as _gelu_plan says (the unaligned view and fp32
    to the CUDA-core kernel, fp32 within 1e-5 of the largest output) and
    bit-equal twice. Returns the kernel's row."""
    from ultravox_torch.scripts.compare_kernels import gelu_chain

    bf = torch.bfloat16
    rec = _recorder([], _bf16_tol)
    shapes, main, edges = {}, None, {}

    def inputs(B, T, D, Fd, dtype, offset=0):
        base = torch.randn((B * T * D + offset,), generator=g, device=dev).to(dtype)
        x = base[offset:].view(B, T, D)
        s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
        b = 0.1 * torch.randn((D,), generator=g, device=dev)
        w = (0.02 * torch.randn((D, Fd), generator=g, device=dev)).to(dtype)
        wb = (0.02 * torch.randn((Fd,), generator=g, device=dev)).to(dtype)
        return x, s, b, w, wb

    for label, (B, T, D, Fd) in GELU_TIMED:
        x, s, b, w, wb = inputs(B, T, D, Fd, bf)
        out = fa.ln_matmul_gelu(x, s, b, w, wb)
        _synced(f"ln_matmul_gelu {label}")
        again = fa.ln_matmul_gelu(x, s, b, w, wb)
        ref = fa.ln_matmul_gelu_plain(x, s, b, w, wb)
        _synced(f"ln_matmul_gelu {label}")
        if not torch.equal(out, again):
            _fail(f"ln_matmul_gelu {label}: two calls differ")
        h = fa._layer_norm_rounded(x, s, b, 1e-5).view(-1, D)
        s_bf, b_bf = s.to(bf), b.to(bf)
        row = rec(
            f"ln_matmul_gelu {label}", "ln_matmul_gelu_mma_kernel",
            "ultravox_torch/ops/kernels/csrc/ln_matmul_gelu.cu",
            "ultravox_tpu/ops/pallas/fused_attention.py:363", out, ref,
            lambda: fa.ln_matmul_gelu(x, s, b, w, wb),
            lambda: fa.ln_matmul_gelu_plain(x, s, b, w, wb),
            None, _nbytes(x, s, b, w, wb, out), 2.0 * B * T * D * Fd, BF16_FLOPS,
            extra={"torch_mm_ms": _time_ms(lambda: torch.mm(h, w)),
                   "chain_ms": _time_ms(lambda: gelu_chain(x, s_bf, b_bf, w, wb)),
                   "plan": fa._gelu_plan(True, B * T, D, Fd, [0], fa._build.sm_count(0))._asdict()},
        )
        shapes[label] = {k: row[k] for k in ("ms", "device_ms", "wrapper_ms", "plain_ms",
                                             "bound_ms", "torch_mm_ms", "chain_ms", "max_abs_err",
                                             "plan")}
        print(f"ln_matmul_gelu {label}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} "
              f"({row['ms'] / row['bound_ms']:.1f}x), torch.mm {row['torch_mm_ms']:.4f}, chain "
              f"{row['chain_ms']:.4f} ({row['ms'] / row['chain_ms']:.2f}x); plan {row['plan']}; "
              f"two calls bit-equal", flush=True)
        main = main or row
        del x, w, out, again, ref, h
    for label, (B, T, D, Fd), dtype, offset in GELU_EDGES:
        x, s, b, w, wb = inputs(B, T, D, Fd, dtype, offset)
        ptrs = [x.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(), 0]
        mma = fa._gelu_plan(dtype == bf, B * T, D, Fd, ptrs, fa._build.sm_count(0)).mma
        if mma != (dtype == bf and offset == 0):
            _fail(f"ln_matmul_gelu {label}: routed to the {'tensor' if mma else 'CUDA'} cores")
        out = fa.ln_matmul_gelu(x, s, b, w, wb)
        _synced(f"ln_matmul_gelu {label}")
        again = fa.ln_matmul_gelu(x, s, b, w, wb)
        ref = fa.ln_matmul_gelu_plain(x, s, b, w, wb)
        _synced(f"ln_matmul_gelu {label}")
        err = float((out.float() - ref.float()).abs().max())
        tol = _bf16_tol(ref) if dtype == bf else 1e-5 * max(1.0, float(ref.abs().max()))
        edges[label] = {"max_abs_err": err, "tol": tol, "tensor_cores": mma}
        print(f"ln_matmul_gelu {label}: max_abs_err {err:.3g} (tol {tol:.3g}), "
              f"{'tensor' if mma else 'CUDA'} cores, two calls bit-equal "
              f"{torch.equal(out, again)}", flush=True)
        if not (err <= tol and torch.equal(out, again)):
            _fail(f"ln_matmul_gelu {label}: {err} > {tol} or two calls differ")
    return dict(main, name="ln_matmul_gelu", shapes=shapes, edge_cases=edges)


# #7's edge cases (timed: compare_kernels.OUT_PROJ_SHAPES, the encoder's
# out-projection at 4 requests and at one, and whisper-large's): label, (B,
# H, T, Dh, M), dtype, element offset of attn in its storage (1: a view the
# 16-byte copies cannot take). A single frame, T 501 (a tile straddles two
# batch rows and the last one is partial), a column-tile tail (M 520),
# heads of 128, 32 heads of 64 into 2048 (Llama-3.2-1B's o_proj width, past
# the CUDA-core tile's 1688), then the unaligned view and fp32 (the
# CUDA-core kernel).
OUT_PROJ_EDGES = (
    ("T 1", (4, 12, 1, 64, 768), torch.bfloat16, 0),
    ("T 501", (2, 12, 501, 64, 768), torch.bfloat16, 0),
    ("M 520", (1, 12, 500, 64, 520), torch.bfloat16, 0),
    ("Dh 128 (2,6,77,128)", (2, 6, 77, 128, 768), torch.bfloat16, 0),
    ("K 2048 M 2048", (2, 32, 100, 64, 2048), torch.bfloat16, 0),
    ("unaligned view (2,12,77,64)", (2, 12, 77, 64, 768), torch.bfloat16, 1),
    ("fp32 (4,12,500,64)", (4, 12, 500, 64, 768), torch.float32, 0),
)
# the ragged shape at which every (bm, tiles) the plan can force runs
OUT_PROJ_FORCED = (2, 12, 501, 64, 520)


def _check_attn_out_proj(fa, dev, g):
    """Phase 2, #7: the tensor-core kernel at OUT_PROJ_SHAPES against its
    plain version (4 bf16 ulps of the largest output), two calls bit-equal,
    timed beside its bound, torch.mm on the concatenated heads (the product
    alone) and the unfused three-call chain (yardsticks: no single call
    computes it); then OUT_PROJ_EDGES, each routed as _out_proj_plan says
    (the unaligned view and fp32 to the CUDA-core kernel, fp32 within 1e-5
    of the largest output) and bit-equal twice, and every tile and count of
    column tiles the plan can force at OUT_PROJ_FORCED. Returns the
    kernel's row."""
    from ultravox_torch.scripts.compare_kernels import (
        OUT_PROJ_SHAPES, _out_proj_inputs, out_proj_chain)

    bf = torch.bfloat16
    rec = _recorder([], _bf16_tol)
    sms = fa._build.sm_count(0)
    shapes, main, edges = {}, None, {}

    def held(label, a, w, b, x, tol_fn):
        out = fa.attn_out_proj_residual(a, w, b, x)
        _synced(f"attn_out_proj_residual {label}")
        again = fa.attn_out_proj_residual(a, w, b, x)
        ref = fa.attn_out_proj_residual_plain(a, w, b, x)
        _synced(f"attn_out_proj_residual {label}")
        err, tol = float((out.float() - ref.float()).abs().max()), tol_fn(ref)
        if not (err <= tol and torch.equal(out, again) and torch.isfinite(out).all()):
            _fail(f"attn_out_proj_residual {label}: {err} > {tol} or two calls differ")
        return out, ref, err, tol

    for label, (B, H, T, Dh, M) in OUT_PROJ_SHAPES.items():
        a, w, b, x = _out_proj_inputs(dev, g, B, H, T, Dh, M, bf)
        out, ref, _, _ = held(label, a, w, b, x, _bf16_tol)
        heads = a.transpose(1, 2).reshape(B * T, H * Dh)
        w2 = w.view(H * Dh, M)
        row = rec(
            f"attn_out_proj_residual {label}", "attn_out_proj_mma_kernel",
            "ultravox_torch/ops/kernels/csrc/attn_out_proj.cu",
            "ultravox_tpu/ops/pallas/fused_attention.py:557", out, ref,
            lambda: fa.attn_out_proj_residual(a, w, b, x),
            lambda: fa.attn_out_proj_residual_plain(a, w, b, x),
            None, _nbytes(a, w, b, x, out), 2.0 * B * T * H * Dh * M, BF16_FLOPS,
            extra={"torch_mm_ms": _time_ms(lambda: torch.mm(heads, w2)),
                   "chain_ms": _time_ms(lambda: out_proj_chain(a, w, b, x)),
                   "plan": fa._out_proj_plan(True, B * T, H, Dh, M, [0], sms)._asdict()},
        )
        shapes[label] = {k: row[k] for k in ("ms", "device_ms", "wrapper_ms", "plain_ms",
                                             "bound_ms", "torch_mm_ms", "chain_ms", "max_abs_err",
                                             "plan")}
        print(f"attn_out_proj_residual {label}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} "
              f"({row['ms'] / row['bound_ms']:.1f}x), plain {row['plain_ms']:.4f}, torch.mm "
              f"{row['torch_mm_ms']:.4f}, chain {row['chain_ms']:.4f} "
              f"({row['ms'] / row['chain_ms']:.2f}x); plan {row['plan']}; two calls bit-equal",
              flush=True)
        main = main or row
        del a, w, x, out, ref, heads
    for label, (B, H, T, Dh, M), dtype, offset in OUT_PROJ_EDGES:
        a, w, b, x = _out_proj_inputs(dev, g, B, H, T, Dh, M, dtype, offset)
        ptrs = [a.data_ptr(), w.data_ptr(), x.data_ptr(), 0]
        mma = fa._out_proj_plan(dtype == bf, B * T, H, Dh, M, ptrs, sms).mma
        if mma != (dtype == bf and offset == 0):
            _fail(f"attn_out_proj_residual {label}: routed to the "
                  f"{'tensor' if mma else 'CUDA'} cores")
        tol_fn = _bf16_tol if dtype == bf else (lambda ref: 1e-5 * max(1.0, float(ref.abs().max())))
        _, _, err, tol = held(label, a, w, b, x, tol_fn)
        edges[label] = {"max_abs_err": err, "tol": tol, "tensor_cores": mma}
        print(f"attn_out_proj_residual {label}: max_abs_err {err:.3g} (tol {tol:.3g}), "
              f"{'tensor' if mma else 'CUDA'} cores, two calls bit-equal", flush=True)
    B, H, T, Dh, M = OUT_PROJ_FORCED
    a, w, b, x = _out_proj_inputs(dev, g, B, H, T, Dh, M, bf)
    forced = {}
    plan = fa._out_proj_plan
    try:
        for bm in fa.MMA_ROWS:
            for k in range(1, -(-M // fa.MMA_BN) + 1):
                fa._out_proj_plan = functools.partial(plan, bm=bm, tiles=k)
                _, _, err, tol = held(f"{OUT_PROJ_FORCED} bm {bm} tiles {k}", a, w, b, x,
                                      _bf16_tol)
                forced[f"{bm}x{fa.MMA_BN} k{k}"] = err
    finally:
        fa._out_proj_plan = plan
    edges[f"forced tiles {OUT_PROJ_FORCED}"] = forced
    print(f"attn_out_proj_residual {OUT_PROJ_FORCED}: every tile and column-tile count forced "
          f"within tolerance, two calls bit-equal; errors {forced}", flush=True)
    return dict(main, name="attn_out_proj_residual", shapes=shapes, edge_cases=edges)


def _check_unwired_kernels(fa, dm, dev):
    """Phase 2, continued: the three kernels the engines do not call (as in
    the reference), at the flagship's shapes. ln_matmul_gelu at the encoder's
    fc1 and attn_out_proj_residual at its out-projection (bf16, B 4 and 1 x
    10 s, and whisper-large's; _check_ln_matmul_gelu, _check_attn_out_proj);
    decode_matmul on every decoder product of Llama-3.2-1B, with a bf16
    weight and an int8 weight + bf16 scale: held against its plain version
    at 1, 4 and 32 rows in bf16 and fp32, then timed at 4 rows (a decode
    step of phase 4) beside torch.mm on the bf16 weight and, for int8,
    lora.py's w8a16 product. Each timed call reads a weight the previous
    calls did not (copies rotate past the 50 MB L2), as a decode step does."""
    from ultravox_torch.models import lora as lora_lib

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    bf = torch.bfloat16
    rows = []

    # 6. LN -> fc1 + b -> tanh-GELU of the encoder FFN
    rows.append(_check_ln_matmul_gelu(fa, dev, g))

    # 7. out-projection + residual, the attention output read head-major
    rows.append(_check_attn_out_proj(fa, dev, g))

    # 14. decode_matmul on every decoder product, bf16 and int8 + scale
    products = {}
    timed = []
    time_rec = _recorder(timed, _bf16_tol)
    worst = 0.0  # the largest error of the checks, as a share of its tolerance
    for name, (K, N) in DECODE_PRODUCTS.items():
        w32 = 0.02 * torch.randn((K, N), generator=g, device=dev)
        scale = (w32.abs().amax(dim=0) / 127).to(bf)
        weights = {"bf16": (w32.to(bf), None),
                   "int8": (torch.round(w32 / scale.float()).clamp(-127, 127).to(torch.int8),
                            scale)}
        del w32
        for kind, (wk, sc) in weights.items():
            for M in (1, 4, 32):
                for dtype in (bf, torch.float32):
                    xm = torch.randn((M, K), generator=g, device=dev).to(dtype)
                    out, ref = dm.decode_matmul(xm, wk, sc), dm.decode_matmul_plain(xm, wk, sc)
                    again = dm.decode_matmul(xm, wk, sc)
                    torch.cuda.synchronize()
                    if not torch.equal(out, again):
                        _fail(f"decode_matmul {name} {kind} M {M} {dtype}: two calls differ")
                    err = float((out.float() - ref.float()).abs().max())
                    # fp32: 1e-5 of the largest output (K up to 8192 terms)
                    tol = _bf16_tol(ref) if dtype == bf else 1e-5 * max(1.0, float(ref.abs().max()))
                    if not err <= tol:
                        _fail(f"decode_matmul {name} {kind} M {M} {dtype}: {err} > {tol}")
                    worst = max(worst, err / tol)
            # timed at 4 rows, bf16, on copies of the weight that rotate past L2
            copies = [wk] + [wk.clone() for _ in range(-(-2 * L2_BYTES // _nbytes(wk)) - 1)]
            nxt = itertools.cycle(copies).__next__
            x4 = torch.randn((4, K), generator=g, device=dev).to(bf)
            out, ref = dm.decode_matmul(x4, wk, sc), dm.decode_matmul_plain(x4, wk, sc)
            torch.cuda.synchronize()
            plan = dm._plan(4, K, N, wk.element_size(), wk.data_ptr(), True, dm._build.sm_count(0))
            w_bf = wk if sc is None else (wk.to(bf) * sc).to(bf)
            bf_copies = [w_bf] + [w_bf.clone() for _ in range(len(copies) - 1)]
            nxt_bf = itertools.cycle(bf_copies).__next__
            mm_fn = lambda: torch.mm(x4, nxt_bf())  # noqa: E731
            extra = {"plan": plan._asdict()}
            if sc is None:
                lib_fn = mm_fn
            else:
                p_int8 = [{"kernel_q": c, "scale": sc} for c in copies]
                nxt_p = itertools.cycle(p_int8).__next__
                extra["bf16_mm_ms"] = _time_ms(mm_fn)
                extra["w8a16_ms"] = _time_ms(lambda: lora_lib.proj_apply(x4, nxt_p()))
                lib_fn = _int8pack_fn(x4, copies, sc, ref, extra)
            row = time_rec(
                f"decode_matmul {name} {kind}", "decode_matmul",
                "ultravox_torch/ops/kernels/csrc/decode_matmul.cu",
                "ultravox_tpu/ops/pallas/decode_matmul.py:68", out, ref,
                lambda: dm.decode_matmul(x4, nxt(), sc),
                lambda: dm.decode_matmul_plain(x4, nxt(), sc), lib_fn,
                _nbytes(x4, wk, out) + (_nbytes(sc) if sc is not None else 0),
                2.0 * 4 * K * N, BF16_FLOPS,
                extra=dict(extra, shape=[4, K, N]),
            )
            mm_ms = row["library_ms"] if sc is None else extra["bf16_mm_ms"]
            row["factor_to_torch_mm"] = row["ms"] / mm_ms
            products[f"{name} {kind}"] = {k_: row[k_] for k_ in (
                "ms", "device_ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                "max_abs_err", "factor_to_torch_mm") + tuple(extra)}
            print(f"decode_matmul {name} {kind} (4, {K}) x ({K}, {N}): kernel {row['ms']:.4f} ms, "
                  f"{row['factor_to_torch_mm']:.2f}x torch.mm on the bf16 weight ({mm_ms:.4f} ms), "
                  f"{100 * row['bound_ms'] / row['ms']:.1f}% of its bound {row['bound_ms']:.5f} ms"
                  + (f"; w8a16 (lora.py, a bf16 copy of the weight per call) "
                     f"{extra['w8a16_ms']:.4f} ms; torch._weight_int8pack_mm "
                     f"{row['library_ms'] if lib_fn else extra['int8pack']}" if sc is not None
                     else "") + f"; plan {extra['plan']}", flush=True)
            del copies, bf_copies, lib_fn
    print(f"check decode_matmul: {len(DECODE_PRODUCTS) * 12} cases (bf16 and int8 weights, "
          f"1/4/32 rows, bf16 and fp32) within tolerance, the largest error "
          f"{worst:.3g} of its tolerance", flush=True)
    print("decode_matmul products at 4 rows: " + json.dumps(products), flush=True)
    main_row = next(r for r in timed if r["name"] == "decode_matmul gateup_proj int8")
    rows.append(dict(main_row, name="decode_matmul", products=products))
    return rows


def _int8pack_fn(x4, copies, sc, ref, extra):
    """torch._weight_int8pack_mm on the int8 weights (transposed to (N, K)
    once, outside the timing, and rotated as the kernel's are), for #14's
    library time; None, with the error it raised in extra["int8pack"], if
    this PyTorch does not run it on CUDA."""
    w_t = [c.t().contiguous() for c in copies]
    try:
        got = torch._weight_int8pack_mm(x4, w_t[0], sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        extra["int8pack"] = f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        return None
    extra["int8pack"] = "ran on CUDA"
    extra["int8pack_max_abs_err"] = float((got.float() - ref.float()).abs().max())
    nxt_t = itertools.cycle(w_t).__next__
    return lambda: torch._weight_int8pack_mm(x4, nxt_t(), sc)


# card ms of #8 and #11 on the one-block kernel of kv_attention.cuh (commit
# 835db08), measured beside the split kernel by
# ultravox_torch/scripts/compare_kernels.py (PERF.md section 6)
ONE_BLOCK_MS = {
    "decode_attention": {"flagship": 0.0214, "serving (c)": 0.0256},
    "segment_tail_attention": {"flagship": 0.0220, "serving (c)": 0.0291},
}
# every length at the split kernel's granule (16 keys) and split (32 keys a
# block) edges on a 256-slot slab, a row of length 0, short rows that leave
# ranks of the cluster empty
EDGE_LENS = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 144, 255, 256)
# #9's and #12's one-block kernel (PR 3's kv_attention.cuh) at the paged
# engine's shapes, ms, as PERF.md records it (NVIDIA H100 80GB HBM3, 700 W)
PAGED_ONE_BLOCK_MS = {"paged_decode_attention": 0.0595, "paged_segment_tail_attention": 0.0630}


def _check_decode_kernels(da, sa, dev):
    """Phase 2, continued: decode_attention and segment_tail_attention at the
    main path's mid-decode shapes (B=4, 32 q / 8 kv heads, head_dim 64, a
    256-slot cache). Each case runs in bf16 and fp32, with ragged lengths
    and windows, twice (bit-equal), and again with 1e4 in every slot a row
    cannot see: the output must not move, which shows those slots never
    enter the kernel. Then _check_split_edges. The main shapes are then
    timed in bf16, and again at serving run (c)'s 2048-slot slab."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, H, Hkv, D, S = 4, 32, 8, 64, 256
    scale = D**-0.5
    rows = []
    record = _recorder(rows, _bf16_tol)

    def ints(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def junk(a, hidden):
        """A copy of a (..., B, S, Hkv, D) with 1e4 where hidden (B, S) holds."""
        out = a.clone()
        out[..., hidden, :, :] = 1e4
        return out

    def check(name, fn, plain, args, hidden):
        """fn(*args) against plain(*args) in bf16 and fp32, and against itself
        with junk in the hidden slots. hidden: {arg index: (B, S*) bool}."""
        for dtype in (torch.bfloat16, torch.float32):
            a = [x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x for x in args]
            out, again, ref = fn(*a), fn(*a), plain(*a)
            for i, h in hidden.items():
                a[i] = junk(a[i], h)
            out_j = fn(*a)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            t = _bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5
            print(f"check {name} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {t:.3g}); "
                  f"junk past the lengths moves it {float((out_j.float() - out.float()).abs().max())}; "
                  f"two runs bit-equal {torch.equal(out, again)}", flush=True)
            if not err <= t:
                _fail(f"{name} ({dtype}) disagrees with its plain version: {err} > {t}")
            if not torch.equal(out, out_j):
                _fail(f"{name} ({dtype}) reads slots past the lengths")
            if not torch.equal(out, again):
                _fail(f"{name} ({dtype}): two runs differ")

    kpos = torch.arange(S, device=dev)

    # 8. decode_attention: one query per row against one layer's cache slab
    q = torch.randn((B, H, D), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    for case, lens, w in (("mid-decode", ints(144, 144, 144, 144), 0),
                          ("ragged", ints(1, 129, 200, 256), 0),
                          ("ragged+window32", ints(1, 129, 200, 256), 32)):
        lo = torch.clamp(lens - w, min=0) if w else torch.zeros_like(lens)
        hidden = (kpos[None] >= lens[:, None]) | (kpos[None] < lo[:, None])
        check(f"decode_attention {case}",
              lambda q, k, v, lens=lens, w=w: da.decode_attention(q, k, v, lens, w, scale=scale),
              lambda q, k, v, lens=lens, w=w: da.decode_attention_plain(q, k, v, lens, w, scale=scale),
              [q, k, v], {1: hidden, 2: hidden})
    _check_split_edges(da, sa, dev)

    bf = torch.bfloat16
    serving_lens = ints(129, 150, 171, 190)
    s_rows = []  # the serving (c) timings, kept in the main rows
    s_record = _recorder(s_rows, _bf16_tol)

    def decode_row(rec, label, qb, kb, vb, lens):
        out = da.decode_attention(qb, kb, vb, lens)
        ref = da.decode_attention_plain(qb, kb, vb, lens, scale=scale)
        torch.cuda.synchronize()
        visible = torch.arange(kb.shape[1], device=dev)[None] < lens[:, None]  # (B, S)
        kv_bytes = 2 * int(visible.sum()) * Hkv * D * kb.element_size()
        return rec(
            label, "decode_attention_split_kernel",
            "ultravox_torch/ops/kernels/csrc/decode_attention.cu",
            "ultravox_tpu/ops/pallas/decode_attention.py:163", out, ref,
            lambda: da.decode_attention(qb, kb, vb, lens),
            lambda: da.decode_attention_plain(qb, kb, vb, lens, scale=scale),
            lambda: F.scaled_dot_product_attention(
                qb[:, :, None], kb.transpose(1, 2), vb.transpose(1, 2),
                attn_mask=visible[:, None, None], enable_gqa=True),
            _nbytes(qb, out, lens) + kv_bytes, 4.0 * H * int(visible.sum()) * D, BF16_FLOPS,
        )

    qb, kb, vb = (x.to(bf) for x in (q, k, v))
    row8 = decode_row(record, "decode_attention", qb, kb, vb, ints(144, 144, 144, 144))
    k2, v2 = (torch.randn((B, 2048, Hkv, D), generator=g, device=dev).to(bf) for _ in range(2))
    row8["serving_c"] = _shape_timing(
        decode_row(s_record, "decode_attention serving (c)", qb, k2, v2, serving_lens))
    del k2, v2

    # 11. segment_tail_attention: the scan's step against layer 7 of a
    # 16-layer stacked cache plus a 31-slot tail
    L, layer, Ts = 16, 7, 31
    kc = torch.randn((L, B, S, Hkv, D), generator=g, device=dev)
    vc = torch.randn((L, B, S, Hkv, D), generator=g, device=dev)
    tk = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    tv = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    tslot = torch.arange(Ts, device=dev)

    def seg_masks(lens, written, T, w):
        """(prompt (B, T, S), tail (B, T, Ts)) visibility, as the kernel's."""
        t = torch.arange(T, device=dev)[None, :, None]
        n, wr = lens[:, None, None], written[:, None, None]
        q_abs = n + wr + t
        ok_p = kpos < n
        ok_t = tslot <= wr + t
        if w:
            ok_p = ok_p & (q_abs - kpos < w)
            ok_t = ok_t & (q_abs - (n + tslot) < w)
        return ok_p, ok_t

    for case, T, lens, written, w in (
        ("scan step", 1, ints(128, 128, 128, 128), ints(15, 15, 15, 15), 0),
        ("T=3 ragged", 3, ints(1, 60, 128, 200), ints(0, 5, 15, 28), 0),
        ("T=3 ragged+window32", 3, ints(1, 60, 128, 200), ints(0, 5, 15, 28), 32),
        ("scan step+window8", 1, ints(128, 128, 128, 128), ints(15, 15, 15, 15), 8),
    ):
        qs = torch.randn((B, T, H, D), generator=g, device=dev)
        ok_p, ok_t = seg_masks(lens, written, T, w)
        check(f"segment_tail_attention {case}",
              lambda q, kc, vc, tk, tv, lens=lens, wr=written, w=w: sa.segment_tail_attention(
                  q, kc, vc, layer, lens, tk, tv, wr, w, scale=scale),
              lambda q, kc, vc, tk, tv, lens=lens, wr=written, w=w: sa.segment_tail_attention_plain(
                  q, kc, vc, layer, lens, tk, tv, wr, w, scale=scale),
              [qs, kc, vc, tk, tv],
              {1: ~ok_p.any(1), 2: ~ok_p.any(1), 3: ~ok_t.any(1), 4: ~ok_t.any(1)})

    def segment_row(rec, label, qb, kcb, vcb, tkb, tvb, lens, written):
        out = sa.segment_tail_attention(qb, kcb, vcb, layer, lens, tkb, tvb, written)
        ref = sa.segment_tail_attention_plain(qb, kcb, vcb, layer, lens, tkb, tvb, written,
                                              scale=scale)
        torch.cuda.synchronize()
        S_, Ts_ = kcb.shape[2], tkb.shape[1]
        t = torch.arange(1, device=dev)[None, :, None]
        ok_p = torch.arange(S_, device=dev) < lens[:, None, None]
        ok_t = torch.arange(Ts_, device=dev) <= written[:, None, None] + t
        keys = int(ok_p.any(1).sum() + ok_t.any(1).sum())  # slots any query of a row sees
        pairs = int(ok_p.sum() + ok_t.sum())  # visible (query, key) pairs, per head
        k_cat = torch.cat([kcb[layer], tkb], dim=1).transpose(1, 2)
        v_cat = torch.cat([vcb[layer], tvb], dim=1).transpose(1, 2)
        mask = torch.cat([ok_p, ok_t], dim=-1)[:, None]
        return rec(
            label, "segment_attention_split_kernel",
            "ultravox_torch/ops/kernels/csrc/segment_attention.cu",
            "ultravox_tpu/ops/pallas/segment_attention.py:203", out, ref,
            lambda: sa.segment_tail_attention(qb, kcb, vcb, layer, lens, tkb, tvb, written),
            lambda: sa.segment_tail_attention_plain(qb, kcb, vcb, layer, lens, tkb, tvb, written,
                                                    scale=scale),
            lambda: F.scaled_dot_product_attention(
                qb.transpose(1, 2), k_cat, v_cat, attn_mask=mask, enable_gqa=True),
            _nbytes(qb, out, lens, written) + 2 * keys * Hkv * D * 2, 4.0 * H * pairs * D,
            BF16_FLOPS,
        )

    qb = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    kcb, vcb, tkb, tvb = (x.to(bf) for x in (kc, vc, tk, tv))
    del kc, vc
    row11 = segment_row(record, "segment_tail_attention", qb, kcb, vcb, tkb, tvb,
                        ints(128, 128, 128, 128), ints(15, 15, 15, 15))
    del kcb, vcb
    # serving run (c)'s block: the slots engine's (16, 4, 2048, 8, 64) cache,
    # an 8-slot tail (decode blocks of 8) with 0-7 written
    kc2, vc2 = (torch.randn((L, B, 2048, Hkv, D), generator=g, device=dev).to(bf)
                for _ in range(2))
    tk2, tv2 = (torch.randn((B, 8, Hkv, D), generator=g, device=dev).to(bf) for _ in range(2))
    row11["serving_c"] = _shape_timing(segment_row(
        s_record, "segment_tail_attention serving (c)", qb, kc2, vc2, tk2, tv2, serving_lens,
        ints(0, 3, 5, 7)))
    del kc2, vc2
    for row in (row8, row11):
        for shape, r in (("flagship", row), ("serving (c)", row["serving_c"])):
            old = ONE_BLOCK_MS[row["name"]][shape]
            print(f"kernel {row['name']} at the {shape} shape: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['ms'] / r['bound_ms']:.1f}x), SDPA "
                  f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), the one-block "
                  f"kernel {old} ms as recorded ({old / r['ms']:.2f}x this)", flush=True)
    return rows


def _check_spec_verify_kernels(sa, dev):
    """Phase 2, continued: #11 and #12 at the speculative verify forward of
    phase 11 (d): q (4, 9, 32, 64) (T = K+1 = 9, 36 query columns a KV
    head), Hkv 8, prompt lengths 129-190 at layer 7 of the slots engine's
    (16, 4, 2048, 8, 64) cache and of a (16, 32, 256, 8, 64) pool of
    shuffled pages holding the same keys, a 72-slot tail (8 rounds of 9)
    with 0, 6, 12 and 18 slots written. bf16, held against the plain
    versions within _bf16_tol, two runs bit-equal, and timed beside the
    bound and (for the slab) SDPA on the concatenated keys."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    B, T, H, Hkv, D, L, layer, S, Ts, ps = 4, 9, 32, 8, 64, 16, 7, 2048, 72, 256
    bf = torch.bfloat16
    scale = D**-0.5

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    q, kc, vc, tk, tv = r(B, T, H, D), r(L, B, S, Hkv, D), r(L, B, S, Hkv, D), r(B, Ts, Hkv, D), r(
        B, Ts, Hkv, D)
    lens = torch.tensor([129, 150, 171, 190], dtype=torch.int32, device=dev)
    written = torch.tensor([0, 6, 12, 18], dtype=torch.int32, device=dev)
    n_per = S // ps
    table = torch.from_numpy(
        np.random.default_rng(SEED + 9).permutation(B * n_per).astype(np.int32)).view(B, n_per)
    table = table.to(dev)
    kp = torch.empty((L, B * n_per, ps, Hkv, D), dtype=bf, device=dev)
    vp = torch.empty_like(kp)
    for b in range(B):
        for i in range(n_per):
            kp[:, table[b, i]] = kc[:, b, i * ps:(i + 1) * ps]
            vp[:, table[b, i]] = vc[:, b, i * ps:(i + 1) * ps]
    t = torch.arange(T, device=dev)[None, :, None]
    ok_p = torch.arange(S, device=dev) < lens.long()[:, None, None]  # (B, 1, S)
    ok_p = ok_p.expand(B, T, S)
    ok_t = torch.arange(Ts, device=dev) <= written.long()[:, None, None] + t  # (B, T, Ts)
    keys = int(ok_p.any(1).sum() + ok_t.any(1).sum())  # slots any query of a row sees
    pairs = int(ok_p.sum() + ok_t.sum())  # visible (query, key) pairs, per head
    k_cat = torch.cat([kc[layer], tk], dim=1).transpose(1, 2)
    v_cat = torch.cat([vc[layer], tv], dim=1).transpose(1, 2)
    mask = torch.cat([ok_p, ok_t], dim=-1)[:, None]
    rows = []
    record = _recorder(rows, _bf16_tol)
    slab = lambda: sa.segment_tail_attention(q, kc, vc, layer, lens, tk, tv, written)  # noqa: E731
    paged = lambda: sa.paged_segment_tail_attention(  # noqa: E731
        q, kp, vp, layer, table, lens, tk, tv, written)
    slab_plain = lambda: sa.segment_tail_attention_plain(  # noqa: E731
        q, kc, vc, layer, lens, tk, tv, written, scale=scale)
    paged_plain = lambda: sa.paged_segment_tail_attention_plain(  # noqa: E731
        q, kp, vp, layer, table, lens, tk, tv, written, scale=scale)
    out, again, out_p, again_p = slab(), slab(), paged(), paged()
    ref, ref_p = slab_plain(), paged_plain()
    torch.cuda.synchronize()
    for name, o, a in (("segment_tail_attention", out, again),
                       ("paged_segment_tail_attention", out_p, again_p)):
        if not torch.equal(o, a):
            _fail(f"{name} at T = 9: two runs differ")
    if not torch.equal(ref, ref_p):
        _fail("the plain versions of #11 and #12 differ on the same keys at T = 9")
    kv_bytes = 2 * keys * Hkv * D * 2
    flops = 4.0 * H * pairs * D
    record("segment_tail_attention (T=9 spec verify)", "segment_attention_split_kernel",
           "ultravox_torch/ops/kernels/csrc/segment_attention.cu",
           "ultravox_tpu/ops/pallas/segment_attention.py:203", out, ref, slab, slab_plain,
           lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_cat, v_cat, attn_mask=mask,
                                                  enable_gqa=True),
           _nbytes(q, out, lens, written) + kv_bytes, flops, BF16_FLOPS)
    record("paged_segment_tail_attention (T=9 spec verify)",
           "paged_segment_attention_split_kernel",
           "ultravox_torch/ops/kernels/csrc/segment_attention.cu",
           "ultravox_tpu/ops/pallas/segment_attention.py:392", out_p, ref_p, paged, paged_plain,
           None, _nbytes(q, out_p, lens, written, table) + kv_bytes, flops, BF16_FLOPS)
    for row in rows:
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['ms'] / row['bound_ms']:.1f}x), plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']} ms", flush=True)
    return rows


def _shape_timing(row):
    """The numbers of a row timed at a second shape, to keep in the main row."""
    return {k: row[k] for k in ("ms", "device_ms", "wrapper_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "max_abs_err", "tol")}


def _check_split_edges(da, sa, dev):
    """Phase 2, continued: the split KV kernel (csrc/kv_split.cuh) of #8 and
    #11 at EDGE_LENS on a 256-slot slab (clusters of 8 blocks), in bf16 (4
    ulps of max|ref|) and fp32 (1e-5), head_dim 64 and 128, GQA 1, 4 and 8,
    windows 0, 8 and 32; #11 at T 1 and 3 with a 32-slot tail (row i has
    7 i mod (33 - T) slots written), layer 1 of 2; then both at serving run
    (c)'s 2048-slot slab (129-190 keys, 8 kv heads, an 8-slot tail). Each
    case: finite, within tolerance, two runs bit-equal, and 1e4 in every
    cache and tail slot no query of a row sees leaves the output bit for
    bit; #8's row of length 0 gives 0."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    Hkv, S, Ts, L = 2, 256, 32, 2
    B = len(EDGE_LENS)
    lens = torch.tensor(EDGE_LENS, dtype=torch.int32, device=dev)
    n = lens.long()[:, None]
    pos, slot = torch.arange(S, device=dev), torch.arange(Ts, device=dev)
    cases, worst = 0, 0.0

    def hold(name, fn, junk_fn, plain, dtype):
        nonlocal cases, worst
        out, again, ref, out_j = fn(), fn(), plain(), junk_fn()
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = _bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5
        if not (err <= tol and torch.isfinite(out).all()):
            _fail(f"split kernel {name}: {err} > {tol} against its plain version")
        if not torch.equal(out, again):
            _fail(f"split kernel {name}: two runs differ")
        if not torch.equal(out, out_j):
            _fail(f"split kernel {name} reads slots no query sees")
        cases += 1
        worst = max(worst, err / tol)
        return out

    def junk(a, hidden):
        out = a.clone()
        out[hidden] = 1e4
        return out

    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
            k, v, kc, vc, tk, tv = (r(B, S, Hkv, D), r(B, S, Hkv, D), r(L, B, S, Hkv, D),
                                    r(L, B, S, Hkv, D), r(B, Ts, Hkv, D), r(B, Ts, Hkv, D))
            for G, w in itertools.product((1, 4, 8), (0, 8, 32)):
                q = r(B, Hkv * G, D)
                hidden = (pos >= n) | (pos < n - w) if w else pos >= n
                jk, jv = junk(k, hidden), junk(v, hidden)
                out = hold(f"decode_attention {str(dtype)[6:]} D {D} G {G} window {w}",
                           lambda: da.decode_attention(q, k, v, lens, w),
                           lambda: da.decode_attention(q, jk, jv, lens, w),
                           lambda: da.decode_attention_plain(q, k, v, lens, w, scale=D**-0.5),
                           dtype)
                if out[0].any():
                    _fail("split kernel decode_attention: a row of length 0 is not 0")
                for T in (1, 3):
                    qs = r(B, T, Hkv * G, D)
                    wr = torch.tensor([(7 * i) % (Ts - T + 1) for i in range(B)],
                                      dtype=torch.int32, device=dev)
                    t = torch.arange(T, device=dev)[None, :, None]
                    ok_p = pos < n[:, :, None]
                    ok_t = slot <= wr.long()[:, None, None] + t
                    if w:
                        ok_p = ok_p & (n[:, :, None] + wr.long()[:, None, None] + t - pos < w)
                        ok_t = ok_t & (wr.long()[:, None, None] + t - slot < w)
                    jkc, jvc, jtk, jtv = kc.clone(), vc.clone(), junk(tk, ~ok_t.any(1)), \
                        junk(tv, ~ok_t.any(1))
                    jkc[1][~ok_p.any(1)], jvc[1][~ok_p.any(1)] = 1e4, 1e4
                    hold(f"segment_tail_attention {str(dtype)[6:]} D {D} G {G} T {T} window {w}",
                         lambda: sa.segment_tail_attention(qs, kc, vc, 1, lens, tk, tv, wr, w),
                         lambda: sa.segment_tail_attention(qs, jkc, jvc, 1, lens, jtk, jtv, wr, w),
                         lambda: sa.segment_tail_attention_plain(qs, kc, vc, 1, lens, tk, tv, wr,
                                                                 w, scale=D**-0.5),
                         dtype)
    # serving run (c)'s shapes: a 2048-slot slab with 129-190 keys, 8 kv
    # heads of GQA 4, head_dim 64; #11 with an 8-slot tail, 0-7 written
    lens = torch.tensor([129, 150, 171, 190], dtype=torch.int32, device=dev)
    hidden = torch.arange(2048, device=dev)[None] >= lens.long()[:, None]
    wr = torch.tensor([0, 3, 5, 7], dtype=torch.int32, device=dev)
    hidden_t = torch.arange(8, device=dev)[None] > wr.long()[:, None]
    for dtype in (torch.bfloat16, torch.float32):
        r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
        q, qs, k, v = r(4, 32, 64), r(4, 1, 32, 64), r(4, 2048, 8, 64), r(4, 2048, 8, 64)
        jk, jv = junk(k, hidden), junk(v, hidden)
        hold(f"decode_attention {str(dtype)[6:]} serving (c) slab",
             lambda: da.decode_attention(q, k, v, lens), lambda: da.decode_attention(q, jk, jv, lens),
             lambda: da.decode_attention_plain(q, k, v, lens, scale=0.125), dtype)
        kc, vc, tk, tv = r(2, 4, 2048, 8, 64), r(2, 4, 2048, 8, 64), r(4, 8, 8, 64), r(4, 8, 8, 64)
        jkc, jvc, jtk, jtv = kc.clone(), vc.clone(), junk(tk, hidden_t), junk(tv, hidden_t)
        jkc[1][hidden], jvc[1][hidden] = 1e4, 1e4
        hold(f"segment_tail_attention {str(dtype)[6:]} serving (c) slab",
             lambda: sa.segment_tail_attention(qs, kc, vc, 1, lens, tk, tv, wr),
             lambda: sa.segment_tail_attention(qs, jkc, jvc, 1, lens, jtk, jtv, wr),
             lambda: sa.segment_tail_attention_plain(qs, kc, vc, 1, lens, tk, tv, wr, scale=0.125),
             dtype)
        del k, v, jk, jv, kc, vc, jkc, jvc
    print(f"check split kernel: {cases} cases of #8 and #11 at lengths {list(EDGE_LENS)} "
          f"(bf16/fp32, D 64/128, G 1/4/8, T 1/3, windows 0/8/32) and at serving (c)'s "
          f"2048-slot slab (129-190 keys) within tolerance, two runs bit-equal, junk in unseen "
          f"slots moving nothing; the largest error {worst:.3g} of its tolerance", flush=True)


def _check_paged_kernels(pa, pg, sa, da, dev):
    """Phase 2, continued: the paged kernels at the shapes the flagship
    paged engine of phase 5 gives them: 4 slots, a pool of 32 pages of 256
    tokens, 16 layers, 8 kv heads of 64, 8 table entries per row, bf16.
    paged_decode_attention and paged_segment_tail_attention run in bf16 and
    fp32 on ragged lengths (up to 1900), windows, pages of 16 and 48 (not a
    power of two), shuffled page ids, sentinel entries and a pageless row of
    length 1, twice (bit-equal), and again with 1e4 in every pool slot (and
    tail slot) no row can see: the output must not move. Then
    _check_paged_split_edges. gather_pages must equal its plain version bit
    for bit. The engine's shapes are then timed in bf16, #9 and #12 beside
    their cluster size, the one-block kernel's recorded time and #8 / #11 on
    the same lengths from a contiguous slab."""
    from ultravox_torch.scripts.compare_kernels import seen_pool_slots

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    B, H, Hkv, D, L, layer, S = 4, 32, 8, 64, 16, 7, 2048
    scale = D**-0.5
    rows = []
    record = _recorder(rows, _bf16_tol)

    def ints(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def table_of(lens, ps, P, seed):
        """(B, S / ps) int32: ceil(n / ps) shuffled pages per row (none for a
        row of length 1, the pageless inactive slot), sentinel P after."""
        order = np.random.default_rng(seed).permutation(P).tolist()
        table = np.full((B, S // ps), P, np.int32)
        for b, n in enumerate(lens.tolist()):
            for i in range(-(-n // ps) if n > 1 else 0):
                table[b, i] = order.pop()
        return torch.from_numpy(table).to(dev)

    def check(name, fn, plain, args, junk_at):
        """fn(*args) against plain(*args) in bf16 and fp32, twice
        (bit-equal), and against itself with 1e4 where junk_at {arg index:
        bool mask} holds."""
        for dtype in (torch.bfloat16, torch.float32):
            a = [x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x for x in args]
            out, again, ref = fn(*a), fn(*a), plain(*a)
            for i, m in junk_at.items():
                a[i] = a[i].clone()
                a[i][m] = 1e4
            out_j = fn(*a)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            t = _bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5
            print(f"check {name} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {t:.3g}); junk in "
                  f"unseen slots moves it {float((out_j.float() - out.float()).abs().max())}; "
                  f"two runs bit-equal {torch.equal(out, again)}", flush=True)
            if not err <= t:
                _fail(f"{name} ({dtype}) disagrees with its plain version: {err} > {t}")
            if not torch.equal(out, out_j) or not torch.isfinite(out).all():
                _fail(f"{name} ({dtype}) reads slots no row can see")
            if not torch.equal(out, again):
                _fail(f"{name} ({dtype}): two runs differ")

    engine_lens = ints(129, 150, 171, 190)
    long_lens = ints(1900, 700, 256, 1)
    cases = (  # name, page size, pages, lengths, window
        ("engine", 256, 32, engine_lens, 0),
        ("long+pageless", 256, 32, long_lens, 0),
        ("long+pageless+window100", 256, 32, long_lens, 100),
        ("ps16+window37", 16, 512, ints(1900, 333, 17, 1), 37),
        ("ps48+window29", 48, 64, ints(1900, 333, 49, 1), 29),
    )

    # 9. paged_decode_attention: one query per row against layer 7's pool
    q = torch.randn((B, H, D), generator=g, device=dev)
    for case, ps, P, lens, w in cases:
        table = table_of(lens, ps, P, SEED)
        kp = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
        vp = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
        lo = [n - w if w else 0 for n in lens.tolist()]
        hide = ~seen_pool_slots(table, lens, lo, ps, P)
        check(f"paged_decode_attention {case}",
              lambda q, k, v, t=table, n=lens, w=w: pa.paged_decode_attention(q, k, v, t, n, w),
              lambda q, k, v, t=table, n=lens, w=w: pa.paged_decode_attention_plain(
                  q, k, v, t, n, w, scale=scale),
              [q, kp, vp], {1: hide, 2: hide})

    # 12. paged_segment_tail_attention: queries at layer 7 of the stacked
    # pool plus an 8-slot tail
    Ts = 8
    tk = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    tv = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    for (case, ps, P, lens, w), T, written in zip(
        cases, (1, 3, 3, 1, 3),
        (ints(0, 3, 5, 7), ints(0, 2, 5, 4), ints(5, 0, 3, 1), ints(7, 0, 3, 1), ints(2, 5, 0, 4)),
    ):
        w = 8 if case.startswith("ps16") else w
        table = table_of(lens, ps, P, SEED + 1)
        kp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev)
        vp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev)
        qs = torch.randn((B, T, H, D), generator=g, device=dev)
        lo = [n + wr - w + 1 if w else 0 for n, wr in zip(lens.tolist(), written.tolist())]
        hide = (~seen_pool_slots(table, lens, lo, ps, P))[None].expand(L, P, ps)
        slot = torch.arange(Ts, device=dev)[None]
        hide_t = slot > (written + T - 1)[:, None]
        if w:
            hide_t |= slot < (written - w + 1)[:, None]
        check(f"paged_segment_tail_attention T={T} {case} window{w}",
              lambda q, k, v, a, b, t=table, n=lens, wr=written, w=w:
                  sa.paged_segment_tail_attention(q, k, v, layer, t, n, a, b, wr, w),
              lambda q, k, v, a, b, t=table, n=lens, wr=written, w=w:
                  sa.paged_segment_tail_attention_plain(q, k, v, layer, t, n, a, b, wr, w,
                                                        scale=scale),
              [qs, kp, vp, tk, tv], {1: hide, 2: hide, 3: hide_t, 4: hide_t})
    _check_paged_split_edges(pa, sa, dev)

    # timed at the engine's shapes, bf16, beside #8 / #11 on the same lengths
    bf = torch.bfloat16
    P, ps = 32, 256
    table = table_of(engine_lens, ps, P, SEED)
    kp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev).to(bf)
    vp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev).to(bf)
    qb = q.to(bf)
    written = ints(0, 3, 5, 7)
    tkb, tvb = tk.to(bf), tv.to(bf)
    qsb = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    kc, vc = (torch.randn((L, B, S, Hkv, D), generator=g, device=dev).to(bf) for _ in range(2))
    same_lengths = {  # #8 and #11 on a contiguous slab with the same lengths
        "paged_decode_attention": lambda: da.decode_attention(qb, kc[layer], vc[layer],
                                                              engine_lens),
        "paged_segment_tail_attention": lambda: sa.segment_tail_attention(
            qsb, kc, vc, layer, engine_lens, tkb, tvb, written),
    }
    keys = int(engine_lens.sum())  # visible keys of all rows
    out = pa.paged_decode_attention(qb, kp[layer], vp[layer], table, engine_lens)
    ref = pa.paged_decode_attention_plain(qb, kp[layer], vp[layer], table, engine_lens, scale=scale)
    torch.cuda.synchronize()
    record(
        "paged_decode_attention", "paged_decode_attention_split_kernel",
        "ultravox_torch/ops/kernels/csrc/paged_attention.cu",
        "ultravox_tpu/ops/pallas/paged_attention.py:150", out, ref,
        lambda: pa.paged_decode_attention(qb, kp[layer], vp[layer], table, engine_lens),
        lambda: pa.paged_decode_attention_plain(qb, kp[layer], vp[layer], table, engine_lens,
                                                scale=scale),
        None, _nbytes(qb, out, engine_lens, table) + 2 * keys * Hkv * D * 2,
        4.0 * H * keys * D, BF16_FLOPS, extra={"cluster": pa.kv_splits(table.shape[1] * ps)},
    )

    out = sa.paged_segment_tail_attention(qsb, kp, vp, layer, table, engine_lens, tkb, tvb, written)
    ref = sa.paged_segment_tail_attention_plain(qsb, kp, vp, layer, table, engine_lens, tkb, tvb,
                                                written, scale=scale)
    torch.cuda.synchronize()
    keys_t = keys + int((written + 1).sum())  # prompt keys + tail slots 0..written
    record(
        "paged_segment_tail_attention", "paged_segment_attention_split_kernel",
        "ultravox_torch/ops/kernels/csrc/segment_attention.cu",
        "ultravox_tpu/ops/pallas/segment_attention.py:392", out, ref,
        lambda: sa.paged_segment_tail_attention(qsb, kp, vp, layer, table, engine_lens, tkb, tvb,
                                                written),
        lambda: sa.paged_segment_tail_attention_plain(qsb, kp, vp, layer, table, engine_lens, tkb,
                                                      tvb, written, scale=scale),
        None, _nbytes(qsb, out, engine_lens, written, table) + 2 * keys_t * Hkv * D * 2,
        4.0 * H * keys_t * D, BF16_FLOPS,
        extra={"cluster": sa.kv_splits(table.shape[1] * ps + Ts)},
    )
    for row in rows:
        row["contiguous_ms"] = _time_ms(same_lengths[row["name"]])
        recorded = PAGED_ONE_BLOCK_MS[row["name"]]  # printed only: not measured in this run
        print(f"kernel {row['name']} at the paged engine's shape: {row['ms']:.4f} ms in clusters "
              f"of {row['cluster']}, bound {row['bound_ms']:.5f} ms "
              f"({row['ms'] / row['bound_ms']:.1f}x); the one-block kernel "
              f"{recorded} ms as PERF.md records it ({recorded / row['ms']:.2f}x "
              f"this); {'#8' if 'decode' in row['name'] else '#11'} on the same lengths "
              f"{row['contiguous_ms']:.4f} ms, so the page lookup costs "
              f"{row['ms'] - row['contiguous_ms']:+.4f} ms", flush=True)
    del kc, vc

    # 10. gather_pages: the whole pool to the (16, 4, 2048, 8, 64) views a
    # paged block reads (each row owns one page; its 7 sentinel entries copy
    # page P - 1)
    ko, vo = pg.gather_pages(kp, vp, table)
    rk = pa.gather_pages_plain(kp, table)
    rv = pa.gather_pages_plain(vp, table)
    torch.cuda.synchronize()
    if not (torch.equal(ko, rk) and torch.equal(vo, rv)):
        _fail("gather_pages differs from its plain version")
    ids = table.long().clamp(max=P - 1).reshape(-1)
    pages_read = int(torch.unique(ids).numel())
    page_bytes = ps * Hkv * D * 2
    record(
        "gather_pages", "paged_gather_kernel", "ultravox_torch/ops/kernels/csrc/paged_gather.cu",
        "ultravox_tpu/ops/pallas/paged_gather.py:69", ko, rk,
        lambda: pg.gather_pages(kp, vp, table),
        lambda: (pa.gather_pages_plain(kp, table), pa.gather_pages_plain(vp, table)),
        lambda: (torch.index_select(kp, 1, ids), torch.index_select(vp, 1, ids)),
        _nbytes(ko, vo, table) + 2 * L * pages_read * page_bytes, 0.0, BF16_FLOPS,
    )
    return rows


def _check_paged_split_edges(pa, sa, dev):
    """Phase 2, continued: the paged instances of the split KV kernel (#9 and
    #12) on compare_kernels.paged_edge_inputs: one row per PAGED_EDGE_LENS
    length, in pools of pages of 16, 48 and 256 (n_per = ceil(1920 / ps),
    clusters of 8; shuffled ids, 3 spare pages, rows of length 0 and 1 own
    no page, sentinel entries after each row's pages), in bf16 (4 ulps of
    max|ref|) and fp32 (1e-5), head_dim 64 and 128, GQA 1, 4 and 8, windows
    0 and 37 (mid-page); #12 at T 1 and 3 with a 32-slot tail at layer 1 of
    2. Each case: finite, within tolerance, two runs bit-equal, and 1e4 in
    every pool slot no row reads (and every unseen tail slot, and all of
    layer 0) leaves the output bit for bit; #9's row of length 0 gives 0."""
    from ultravox_torch.scripts.compare_kernels import PAGED_EDGE_LENS, paged_edge_inputs

    cases, worst = 0, 0.0

    def hold(name, fn, junk_fn, plain, dtype):
        nonlocal cases, worst
        out, again, ref, out_j = fn(), fn(), plain(), junk_fn()
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = _bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5
        if not (err <= tol and torch.isfinite(out).all()):
            _fail(f"paged split kernel {name}: {err} > {tol} against its plain version")
        if not torch.equal(out, again):
            _fail(f"paged split kernel {name}: two runs differ")
        if not torch.equal(out, out_j):
            _fail(f"paged split kernel {name} reads slots no query sees")
        cases += 1
        worst = max(worst, err / tol)
        return out

    def junk(t, hidden):
        t = t.clone()
        t[hidden] = 1e4
        return t

    for dtype, D, ps, G, w in itertools.product((torch.bfloat16, torch.float32), (64, 128),
                                                (16, 48, 256), (1, 4, 8), (0, 37)):
        tag = f"{str(dtype)[6:]} D {D} ps {ps} G {G} window {w}"
        c = paged_edge_inputs(dev, dtype, D, G, ps, w, seed=SEED + ps)
        q, kp, vp, table, lens = c["q"], c["kp"][1], c["vp"][1], c["table"], c["lens"]
        jk, jv = junk(kp, c["hidden"]), junk(vp, c["hidden"])
        out = hold(f"paged_decode_attention {tag}",
                   lambda: pa.paged_decode_attention(q, kp, vp, table, lens, w),
                   lambda: pa.paged_decode_attention(q, jk, jv, table, lens, w),
                   lambda: pa.paged_decode_attention_plain(q, kp, vp, table, lens, w,
                                                           scale=D**-0.5), dtype)
        if out[0].any():
            _fail("paged split kernel paged_decode_attention: a row of length 0 is not 0")
        for T in (1, 3):
            c = paged_edge_inputs(dev, dtype, D, G, ps, w, T=T, seed=SEED + ps + T)
            qs, kp, vp, table, lens = c["q"], c["kp"], c["vp"], c["table"], c["lens"]
            tk, tv, wr, hidden_t = c["tk"], c["tv"], c["written"], c["hidden_tail"]
            jkp, jvp = kp.clone(), vp.clone()
            jkp[1][c["hidden"]], jvp[1][c["hidden"]] = 1e4, 1e4
            jkp[0], jvp[0] = 1e4, 1e4  # another layer
            jtk, jtv = junk(tk, hidden_t), junk(tv, hidden_t)
            hold(f"paged_segment_tail_attention {tag} T {T}",
                 lambda: sa.paged_segment_tail_attention(qs, kp, vp, 1, table, lens, tk, tv, wr, w),
                 lambda: sa.paged_segment_tail_attention(qs, jkp, jvp, 1, table, lens, jtk, jtv,
                                                         wr, w),
                 lambda: sa.paged_segment_tail_attention_plain(qs, kp, vp, 1, table, lens, tk, tv,
                                                               wr, w, scale=D**-0.5),
                 dtype)
    print(f"check paged split kernel: {cases} cases of #9 and #12 at lengths "
          f"{list(PAGED_EDGE_LENS)} (bf16/fp32, D 64/128, pages of 16/48/256, G 1/4/8, T 1/3, "
          f"windows 0/37) within tolerance, two runs bit-equal, junk in unseen slots moving "
          f"nothing; the largest error {worst:.3g} of its tolerance", flush=True)


# library: (its bf16 tensor-core kernels, instantiations of each, a name
# that only its fp32 CUDA-core kernels hold, the mangled prefix of the
# tensor-core kernels ptxas must report no spills for, and how many those
# are: the attention kernels' head_dim 64 half, every decode_matmul one)
MMA_BUILDS = {
    "flash_attention": (("flash_fwd_mma_kernel", "flash_delta_mma_kernel", "flash_dkdv_mma_kernel",
                         "flash_dq_mma_kernel"), 2, "kernelIf", "_mma_kernelILi64E", 4),
    "attention": (("attention_mma_kernel",), 2, "attention_kernelIf", "attention_mma_kernelILi64E",
                  1),
    "encoder_attn_probe": (("attention_mma_kernel",), 4, "attention_kernelIf",
                           "attention_mma_kernelILi64E", 2),
    # bf16 x: 9 bf16-weight and 13 int8-weight instances (csrc/decode_matmul.cu
    # dispatch_mma); fp32 x runs decode_matmul_kernel on the CUDA cores
    "decode_matmul": (("decode_matmul_mma_kernel",), 22, "decode_matmul_kernel",
                      "decode_matmul_mma_kernel", 22),
    # #2: the 128-, 64- and 32-row tensor-core tiles (ops/kernels/fused_attention.py
    # MMA_ROWS; no instance depends on D, so the spill check holds at D 768);
    # fp32 and unaligned views run ln_qkv_head_kernel on the CUDA cores
    "ln_qkv_head": (("ln_qkv_head_mma_kernel",), 3, "ln_qkv_head_kernelIf",
                    "ln_qkv_head_mma_kernel", 3),
    # #6: the same three tiles with a GELU epilogue (fused_attention._gelu_plan);
    # fp32 and unaligned views run ln_matmul_gelu_kernel on the CUDA cores
    "ln_matmul_gelu": (("ln_matmul_gelu_mma_kernel",), 3, "ln_matmul_gelu_kernelIf",
                       "ln_matmul_gelu_mma_kernel", 3),
    # #7: the same three tiles with a gather prologue and a bias + residual
    # epilogue (fused_attention._out_proj_plan); fp32 and unaligned views run
    # attn_out_proj_kernel on the CUDA cores
    "attn_out_proj": (("attn_out_proj_mma_kernel",), 3, "attn_out_proj_kernelIf",
                      "attn_out_proj_mma_kernel", 3),
}


def _check_mma_build(_build, name, info):
    """Phase 1, continued: the bf16 kernels of flash_attention (forward,
    delta, dK/dV, dQ), attention (#3/#4), encoder_attn_probe (#15/#16,
    both exponents), decode_matmul (#14, bf16 x), ln_qkv_head (#2),
    ln_matmul_gelu (#6) and attn_out_proj (#7) run on the tensor cores.
    cuobjdump's SASS of the built library must show HMMA in every bf16
    instantiation (head_dim 64 and 128; every #14 instance) and none in the
    fp32 kernels (fp32 stays on the CUDA cores). ptxas must report no spills
    for the head_dim 64 bf16 attention kernels and every #14, #2, #6 and #7
    tensor-core kernel."""
    kernels, n_inst, fp32_name, d64_name, n_spill = MMA_BUILDS[name]
    path = info["path"]
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        _fail(f"phase 1: no cuobjdump beside nvcc ({cuobjdump}) to read the {name} kernels' SASS")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    hmma = {}
    for block in sass.split("Function : ")[1:]:
        hmma[block.split("\n", 1)[0].strip()] = block.count("HMMA")
    for kern in kernels:
        mine = {n: c for n, c in hmma.items() if kern in n}
        print(f"sass {name} {kern}: HMMA per instantiation {sorted(mine.values())}", flush=True)
        if len(mine) != n_inst or not all(mine.values()):
            _fail(f"phase 1: {name} {kern} holds no tensor-core instruction in one of its "
                  f"{n_inst} instantiations ({mine})")
    fp32 = {n: c for n, c in hmma.items() if fp32_name in n}
    print(f"sass fp32 {name} kernels: {len(fp32)} instantiations, HMMA {sum(fp32.values())}",
          flush=True)
    if not fp32 or any(fp32.values()):
        _fail(f"phase 1: the fp32 {name} kernels should stay on the CUDA cores ({fp32})")
    if not info["ptxas"]:
        print(f"ptxas {name}: library already built, no report to check", flush=True)
        return
    spills, fn = {}, None
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line and fn is not None:
            spills[fn] = int(line.split("bytes spill stores")[0].split(",")[-1])
    d64 = {n: b for n, b in spills.items() if d64_name in n}
    print(f"ptxas bf16 {name} kernels ({d64_name}): spill store bytes {sorted(d64.values())}",
          flush=True)
    if len(d64) != n_spill or any(d64.values()):
        _fail(f"phase 1: the {d64_name} {name} kernels spill or were not found ({d64})")


def _check_split_build(built):
    """Phase 1, continued: ptxas reports no spills for the split KV kernel's
    head_dim 64 instantiations (bf16 and fp32): the contiguous ones in
    decode_attention (#8) and segment_attention (#11), the paged ones in
    paged_attention (#9) and segment_attention (#12)."""
    for name, kernel in (("decode_attention", "decode_attention_split_kernel"),
                         ("segment_attention", "segment_attention_split_kernel"),
                         ("paged_attention", "paged_decode_attention_split_kernel"),
                         ("segment_attention", "paged_segment_attention_split_kernel")):
        log = built[name]["ptxas"]
        if not log:
            print(f"ptxas {name}: library already built, no report to check", flush=True)
            continue
        mangled = f"_Z{len(kernel)}{kernel}I"  # this __global__'s instances, no other's
        spills, regs, fn = {}, {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn is not None and fn.startswith(mangled) and "Li64E" in fn:
                if "spill stores" in line:
                    spills[fn] = (int(line.split("bytes spill stores")[0].split(",")[-1]),
                                  int(line.split("bytes spill loads")[0].split(",")[-1]))
                elif "Used" in line and "registers" in line:
                    regs[fn] = int(line.split("Used")[1].split("registers")[0])
        print(f"ptxas {kernel} at D 64: spill store/load bytes {sorted(spills.values())}, "
              f"registers {sorted(regs.values())}", flush=True)
        if len(spills) != 2 or any(a or b for a, b in spills.values()):
            _fail(f"phase 1: the D = 64 {kernel} instantiations spill or were not found ({spills})")


def _one_block_kv_kernels(keys):
    """Names of the one-block KV kernels that the split kernel replaced
    (#8's, #11's, and #9's and #12's paged ones) among trace keys."""
    return [k for k in keys
            if re.search(r"(?<![A-Za-z_])(paged_)?(decode|segment)_attention_kernel(?![a-z_])", k)]


SPLIT_KERNELS = ("decode_attention_split_kernel", "segment_attention_split_kernel",
                 "paged_decode_attention_split_kernel", "paged_segment_attention_split_kernel")


def _split_kernel_ms(evs, label):
    """Print (and return) the device ms and launches of the split KV
    kernels (#8, #11, #9, #12) among profiler events; fail if a one-block
    kernel ran."""
    out = {}
    for kernel in SPLIT_KERNELS:
        # this kernel's name, not inside another's ("paged_" + it)
        mine = [e for e in evs if re.search(rf"(?<![A-Za-z_]){kernel}(?![a-z_])", e.key)]
        out[kernel] = (sum(e.self_device_time_total for e in mine) / 1e3,
                       sum(e.count for e in mine))
        print(f"  {label}: {kernel} {out[kernel][0]:.3f} ms in {out[kernel][1]} launches",
              flush=True)
    old = _one_block_kv_kernels(e.key for e in evs)
    if old:
        _fail(f"{label}: the trace shows one-block KV kernels {sorted(set(old))}")
    return out


def _flash_grads(fn, q, k, v, dout, lens, kw):
    """(out, dq, dk, dv) of fn's forward and its backward under dout."""
    x = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*x, lens, **kw)
    out.backward(dout)
    return (out.detach(), *(t.grad for t in x))


def _check_flash(fl, dev):
    """Phase 2, continued: flash_attention's forward kernel and its three
    backward kernels against the plain autograd Function (the JAX custom
    VJP's formulas). First in fp32 and bf16 on ragged lengths, a row of
    length 0, a sliding window (whose padding rows past length + window see
    no key), the latency block and head_dim 128, every output finite; then
    with 1e4 in every key and value past each row's length, which must move
    neither the output nor any gradient (dk and dv of those keys stay 0).
    Then forward and backward are timed in bf16 at the flagship training
    shapes: the decoder's (8, 190, 32/8 heads, 64), causal, and the
    encoder's (8, 500, 12, 64) with a key-length mask."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = []
    scale = 64**-0.5

    def make(B, T, H, Hkv, D, lengths, dtype):
        r = [torch.randn(s, generator=g, device=dev).to(dtype)
             for s in ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, H, D))]
        return (*r, torch.tensor(lengths, dtype=torch.int32, device=dev))

    def plain(q, k, v, lens, causal=False, window=0, latency_block=0):
        return fl._FlashPlain.apply(q, k, v, lens, q.shape[-1] ** -0.5, causal, window,
                                    latency_block)

    cases = (  # name, B, T, H, Hkv, D, lengths, causal, window, latency block
        ("decoder causal ragged", 4, 190, 32, 8, 64, [190, 77, 1, 0], True, 0, 0),
        ("decoder causal window 32", 4, 190, 32, 8, 64, [190, 120, 50, 3], True, 32, 0),
        ("encoder latency 16 ragged", 4, 500, 12, 12, 64, [500, 311, 64, 0], False, 0, 16),
        ("head_dim 128 gqa 4", 2, 77, 8, 2, 128, [77, 30], False, 0, 0),
        # the bf16 kernels' 64-row tiles: whole, one row past, two, ragged
        ("tile edge T1", 2, 1, 4, 1, 64, [1, 0], True, 0, 0),
        ("tile edge T17 window", 2, 17, 4, 1, 64, [17, 9], True, 5, 0),
        ("tile edge T64 head_dim 128", 2, 64, 4, 4, 128, [64, 40], False, 0, 0),
        ("tile edge T65 head_dim 128 causal", 2, 65, 4, 2, 128, [65, 64], True, 0, 0),
        ("tile edge T128 head_dim 128 latency", 2, 128, 4, 1, 128, [128, 1], False, 0, 16),
        ("T500 head_dim 128 gqa 4 window", 3, 500, 8, 2, 128, [500, 257, 0], True, 48, 0),
    )
    for name, B, T, H, Hkv, D, lengths, causal, window, lb in cases:
        kw = dict(causal=causal, window=window, latency_block=lb)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout, lens = make(B, T, H, Hkv, D, lengths, dtype)
            got = _flash_grads(fl.flash_attention, q, k, v, dout, lens, kw)
            ref = _flash_grads(plain, q, k, v, dout, lens, kw)
            again = _flash_grads(fl.flash_attention, q, k, v, dout, lens, kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                _fail(f"flash_attention {name} ({dtype}): two runs differ (the kernels must be "
                      "deterministic)")
            errs = ["two runs bit-equal"]
            for what, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
                err = float((a.float() - b.float()).abs().max())
                if dtype == torch.float32:
                    t = 1e-5 if what == "out" else 1e-4
                else:
                    t = _bf16_tol(b) + (0.0 if what == "out" else 1e-6)
                    rms = _rel_rms(a, b)
                    errs.append(f"{what} rel_rms {rms:.3g} (tol {FLASH_RMS_TOL:.3g})")
                    if not rms <= FLASH_RMS_TOL:
                        _fail(f"flash_attention {name} ({dtype}) {what}: relative RMS error "
                              f"{rms} > {FLASH_RMS_TOL}")
                errs.append(f"{what} {err:.3g} (tol {t:.3g})")
                if not err <= t or not torch.isfinite(a).all():
                    _fail(f"flash_attention {name} ({dtype}) {what} disagrees with its plain "
                          f"version: {err} > {t}")
            print(f"check flash_attention {name} {str(dtype)[6:]}: {'; '.join(errs)}", flush=True)

    for name, T, H, Hkv, lengths, causal, lb in (
        ("decoder causal", 190, 32, 8, [190, 77, 3, 1], True, 0),
        ("encoder latency 16", 500, 12, 12, [500, 311, 64, 9], False, 16),
    ):
        kw = dict(causal=causal, latency_block=lb)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout, lens = make(4, T, H, Hkv, 64, lengths, dtype)
            past = torch.arange(T, device=dev)[None] >= lens[:, None]
            jk, jv = k.clone(), v.clone()
            jk[past], jv[past] = 1e4, 1e4
            got = _flash_grads(fl.flash_attention, q, k, v, dout, lens, kw)
            junk = _flash_grads(fl.flash_attention, q, jk, jv, dout, lens, kw)
            torch.cuda.synchronize()
            moved = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, junk)]
            print(f"check flash_attention junk past the lengths, {name} {str(dtype)[6:]}: "
                  f"moves out/dq/dk/dv by {moved}", flush=True)
            if not all(torch.equal(a, b) for a, b in zip(got, junk)):
                _fail(f"flash_attention ({name}, {dtype}) reads keys past the lengths")

    def timed(label, B, T, H, Hkv, causal):
        """Forward and backward rows at one shape (bf16, every key valid)."""
        q, k, v, dout, lens = make(B, T, H, Hkv, 64, [T] * B, torch.bfloat16)
        kw = dict(scale=scale, causal=causal)
        pairs = B * (T * (T + 1) // 2 if causal else T * T)  # visible (query, key) pairs per head
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        out, stats = fl.flash_forward(q, k, v, lens, **kw)
        ref = fl.flash_forward_plain(q, k, v, lens, **kw)
        torch.cuda.synchronize()
        rec_rows = []
        rec = _recorder(rec_rows, _bf16_tol)

        def check_rms(what, a, b):
            rms = _rel_rms(a, b)
            print(f"check flash_attention ({label}) {what}: rel_rms {rms:.3g} "
                  f"(tol {FLASH_RMS_TOL:.3g})", flush=True)
            if not rms <= FLASH_RMS_TOL:
                _fail(f"flash_attention ({label}) {what}: relative RMS error {rms} > "
                      f"{FLASH_RMS_TOL}")
            return rms

        rel_rms = check_rms("out", out, ref)
        fwd_flops, bwd_flops = 4.0 * 64 * H * pairs, 10.0 * 64 * H * pairs

        row = rec(f"flash_attention ({label})", "flash_fwd_mma_kernel",
            "ultravox_torch/ops/kernels/csrc/flash_attention.cu",
            "ultravox_tpu/ops/pallas/flash_attention.py:274 (_fwd_kernel :78)", out, ref,
            lambda: fl.flash_forward(q, k, v, lens, **kw),
            lambda: fl.flash_forward_plain(q, k, v, lens, **kw),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=True),
            _nbytes(q, k, v, out, stats, lens), fwd_flops, BF16_FLOPS,
            extra={"rel_rms_err": rel_rms})
        _rate(row, fwd_flops)
        grads = fl.flash_backward(q, k, v, out, stats, dout, lens, **kw)
        refs = fl.flash_backward_plain(q, k, v, out, dout, lens, **kw)
        torch.cuda.synchronize()
        rel_rms = 0.0
        for what, a, b in zip(("dq", "dk", "dv"), grads, refs):
            err = float((a.float() - b.float()).abs().max())
            print(f"check flash_attention backward ({label}) {what}: max_abs_err {err:.3g} "
                  f"(tol {_bf16_tol(b):.3g})", flush=True)
            if not err <= _bf16_tol(b):
                _fail(f"flash_attention backward ({label}) {what} disagrees: {err}")
            rel_rms = max(rel_rms, check_rms(what, a, b))
        x = [t.detach().clone().requires_grad_() for t in (qh, kh, vh)]
        doh = dout.transpose(1, 2)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(*x, is_causal=causal, enable_gqa=True).backward(doh)

        # the library's backward alone: PyTorch's flash-attention backward op
        # on k/v expanded over the GQA group (it takes no groups; summing its
        # dk/dv over the group is left out), with the logsumexp of its own
        # forward at the same inputs
        ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (kh, vh))
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            qh, ke, ve, 0.0, causal, False, scale=scale)
        o_lib, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

        def library_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                doh, qh, ke, ve, o_lib, lse, cq, ck, mq, mk, 0.0, causal, seed, offset,
                scale=scale)

        row = rec(f"flash_attention_bwd ({label})", "flash_d",
            "ultravox_torch/ops/kernels/csrc/flash_attention.cu",
            "ultravox_tpu/ops/pallas/flash_attention.py:274 (_bwd_kernel :104)",
            torch.cat([t.flatten() for t in grads]), torch.cat([t.flatten() for t in refs]),
            lambda: fl.flash_backward(q, k, v, out, stats, dout, lens, **kw),
            lambda: fl.flash_backward_plain(q, k, v, out, dout, lens, **kw), library_bwd,
            _nbytes(q, k, v, out, stats, dout, lens, *grads), bwd_flops, BF16_FLOPS,
            calls=fl.BWD_LAUNCHES, extra={"sdpa_fwd_bwd_ms": _time_ms(sdpa_fwd_bwd),
                                          "rel_rms_err": rel_rms})
        _rate(row, bwd_flops)
        return rec_rows

    dec = timed("decoder (8,190,32/8,64) causal", 8, 190, 32, 8, True)
    enc = timed("encoder (8,500,12,64)", 8, 500, 12, 12, False)
    for name, d, e in zip(("flash_attention", "flash_attention_bwd"), dec, enc):
        row = dict(d, name=name, shape="decoder (8,190,32/8,64) causal, lengths 190")
        row["encoder_shape"] = {k_: e[k_] for k_ in (
            "max_abs_err", "tol", "rel_rms_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "wrapper_ms", "tflops", "library_factor")
            + (("sdpa_fwd_bwd_ms",) if "sdpa_fwd_bwd_ms" in e else ())}
        rows.append(row)
    return rows


TRAINABLE = (r".*projector/.*", r".*audio_tower/.*lora_[ab]$")


def _small_train_parity(tc, dev):
    """Phase 3, continued: two KL train steps (remat, vocab_chunk 16) of the
    small llama speech model (weights scaled as in the parity tests) with a
    rank-4 audio LoRA on q_proj/v_proj (lora_b away from 0), projector and
    LoRA trainable, fp32: on the card
    through the flash_attention kernels against the same steps on the CPU
    through their plain versions. Loss and param_norm within rtol 1e-5,
    grad_norm within 1e-4 and each leaf's step-0 gradient within 1e-3 of its
    largest element (the card's cuBLAS and flash kernels sum the backward in
    other orders than the CPU, and a KL gradient is a small difference of
    large terms); frozen leaves unchanged; the updated trainable leaves
    within 1e-5 where the clipped CPU gradient exceeds 1e-7, as in
    tests/test_torch_train.py."""
    from ultravox_torch.models import lora
    from ultravox_torch.models import ultravox as uv
    from ultravox_torch.ops.kernels import flash_attention as fl
    from ultravox_torch.ops.mel import log_mel_spectrogram_np
    from ultravox_torch.training import train_step as ts

    cfg = tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(d_model=128, num_layers=2, num_heads=2, ffn_dim=256),
        text_config=tc.DecoderConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=64, rope_theta=500000.0, rope_scaling=(32.0, 1.0, 4.0, 8192),
            tie_word_embeddings=True),
        hidden_size=256, projector_ln_mid=True,
    )
    params = uv.init_params(cfg, torch.Generator().manual_seed(SEED))
    # the weights of tests/torch_parity.make_params: a KL loss near 0 would
    # leave only rounding noise to compare
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 8.0}
    params = {k: _scale(v, scale[k]) for k, v in params.items()}
    params = lora.apply_lora_to_model(
        params, tc.LoraConfig(), tc.LoraConfig(r=4, target_modules=("q_proj", "v_proj")),
        torch.Generator().manual_seed(SEED + 1))
    gen = torch.Generator().manual_seed(SEED + 2)
    for name in ("q_proj", "v_proj"):
        p = params["audio_tower"]["layers"][name]
        p["lora_b"] = 0.05 * torch.randn(p["lora_b"].shape, generator=gen)
    rng = np.random.default_rng(SEED)
    mel = torch.from_numpy(np.stack([log_mel_spectrogram_np(a) for a in _audio(2, 1.5, rng)]))
    batch = _batch(cfg, mel, 32, rng)
    batch["audio_lens"][1] = 100  # a ragged encoder length mask
    batch["audio_token_len"][1] = -(-100 // cfg.audio_token_compression)
    batch["attention_mask"][1, 28:] = 0
    B, T, T2 = 2, 32, 20
    labels = np.full((B, T), -100, np.int64)
    labels[0, 20:32] = batch["input_ids"][0, 20:32]
    labels[1, 20:28] = batch["input_ids"][1, 20:28]
    alt_labels = np.full((B, T2), -100, np.int64)
    alt_labels[0, 8:20] = labels[0, 20:32]
    alt_labels[1, 8:15] = labels[1, 21:28]
    alt_mask = np.ones((B, T2), np.int64)
    alt_mask[1, 18:] = 0
    batch.update(labels=labels, alt_input_ids=rng.integers(1, 512, (B, T2)),
                 alt_attention_mask=alt_mask, alt_labels=alt_labels)
    lc = tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE)
    opt_kw = dict(warmup_steps=1, total_steps=10, weight_decay=0.01, max_grad_norm=0.05)
    out = {}
    for device in ("cpu", dev):
        opt = ts.make_optimizer(1e-3, **opt_kw)
        state, template = ts.init_train_state(params, opt, TRAINABLE, device=device)
        frozen0 = {k: v.clone() for k, v in state.frozen.items()}
        tb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        grads = torch.autograd.grad(uv.ultravox_loss(  # the step-0 gradient
            ts.merge_params(template, state.trainable, state.frozen), cfg, tb, lc, remat=True,
            attn_impl="flash", vocab_chunk=16), list(state.trainable.values()))
        step = ts.make_train_step(cfg, lc, opt, template, remat=True, attn_impl="flash",
                                  vocab_chunk=16)
        before = (fl.flash_attention.launches, fl.flash_attention.bwd_launches)
        metrics = []
        for _ in range(2):
            state, m = step(state, tb)
            metrics.append({k: float(v) for k, v in m.items()})
        if device != "cpu" and not (fl.flash_attention.launches > before[0]
                                    and fl.flash_attention.bwd_launches > before[1]):
            _fail("small train step: the flash_attention kernels were not launched on the card")
        if any(not torch.equal(v.cpu(), frozen0[k].cpu()) for k, v in state.frozen.items()):
            _fail(f"small train step on {device}: a frozen leaf changed")
        out[device] = (metrics, {k: v.detach().cpu() for k, v in state.trainable.items()},
                       [g_.cpu() for g_ in grads])
    (m_cpu, p_cpu, g_cpu), (m_gpu, p_gpu, g_gpu) = out["cpu"], out[dev]
    print(f"small train step: cpu {m_cpu} gpu {m_gpu}", flush=True)
    for a, b in zip(m_cpu, m_gpu):
        for k in a:
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            if not abs(a[k] - b[k]) <= rtol * abs(a[k]):
                _fail(f"small train step: {k} on the card {b[k]} vs the CPU {a[k]}")
    rel = {k: float((a - b).abs().max() / a.abs().max()) for k, a, b in zip(p_cpu, g_cpu, g_gpu)}
    print(f"small train step: step-0 gradient, card vs CPU, max error over max |g| per leaf {rel}",
          flush=True)
    if not all(r <= 1e-3 for r in rel.values()):
        _fail(f"small train step: gradients on the card differ from the CPU's: {rel}")
    clip = min(1.0, opt_kw["max_grad_norm"] / m_cpu[0]["grad_norm"])
    worst = 0.0
    for g_, (k, a) in zip(g_cpu, p_cpu.items()):
        big = g_.abs() * clip > 1e-7
        worst = max(worst, float((a - p_gpu[k])[big].abs().max()))
    print(f"small train step: updated trainable leaves differ by at most {worst:.3g}", flush=True)
    if not worst <= 1e-5:
        _fail(f"small train step: updated parameters differ by {worst}")


def _train_step_flops(cfg, B, T, T2, mel_frames) -> float:
    """Model matmul FLOPs of one KL train step at these shapes: the cost
    model of the JAX package's bench.py (_train_step_flops), plus the
    encoder's activation gradients, which this recipe adds (its LoRA
    adapters train, so the backward runs through every encoder layer).
    Remat's recomputation is not counted (model FLOPs).
    - encoder: forward + dgrad; student decoder layers: forward + dgrad
      (frozen weights get no wgrad); projector: forward + dgrad + wgrad;
      teacher decoder and its LM head: forward; the student's chunked LM
      head: forward + dgrad; attention's QK^T and PV at their quadratic cost."""
    tc_, ac = cfg.text_config, cfg.audio_config
    T_e = mel_frames // 2  # the conv stem downsamples 2x
    d_attn_dec = (tc_.hidden_size * tc_.num_heads * tc_.head_dim * 2
                  + tc_.hidden_size * tc_.num_kv_heads * tc_.head_dim * 2)
    p_dec_layers = tc_.num_layers * (d_attn_dec + 3 * tc_.hidden_size * tc_.intermediate_size)
    p_enc_layers = ac.num_layers * (4 * ac.d_model**2 + 2 * ac.d_model * ac.ffn_dim)
    p_lm_head = tc_.hidden_size * tc_.vocab_size

    def attn_quad(n_layers, n_heads, head_dim, t):
        return n_layers * 4 * t * t * n_heads * head_dim

    fwd_student = 2 * p_dec_layers * B * T + B * attn_quad(
        tc_.num_layers, tc_.num_heads, tc_.head_dim, T)
    fwd_teacher = 2 * p_dec_layers * B * T2 + B * attn_quad(
        tc_.num_layers, tc_.num_heads, tc_.head_dim, T2)
    fwd_encoder = 2 * p_enc_layers * B * T_e + B * attn_quad(
        ac.num_layers, ac.num_heads, ac.d_model // ac.num_heads, T_e)
    n_audio_tok = T_e // cfg.stack_factor
    p_proj = ac.d_model * cfg.stack_factor * cfg.hidden_size + cfg.hidden_size // 2 * tc_.hidden_size
    fwd_proj = 2 * p_proj * B * n_audio_tok
    return (2 * fwd_student + fwd_teacher + 2 * fwd_encoder + 3 * fwd_proj
            + 2 * 2 * p_lm_head * B * T + 2 * p_lm_head * B * T2)


def _train_main_path(tc, uv, dev):
    """Phase 6: the training step of the v0.6 recipe at flagship widths.
    bf16 weights from the seed plus an fp32 audio LoRA (r 8, alpha 8) on
    q_proj/v_proj; projector and LoRA trainable; KL distillation against the
    text-only teacher, remat, vocab_chunk 256, attn_impl "flash";
    make_optimizer(1e-4, warmup_steps=0, total_steps=100). The batch of the
    JAX package's bench.py (_train_metrics): 8 rows, 10 s of synthesized
    audio each (1000 mel frames, 62 audio tokens at position 4), T 190, T2
    128, 40 labelled tokens. After two warm-up steps the launch counts are
    set to 0 and N steps run: each step must launch flash_attention's
    forward 2 x 12 + 3 x 16 = 72 times (encoder forward and remat
    recompute, student forward and recompute, teacher forward) and its
    backward 12 + 16 = 28 times (x BWD_LAUNCHES kernels). Then one traced
    step (busy share, kernels by time) and one step with CUDA sync
    debugging, which fails on any host wait."""
    from torch.profiler import ProfilerActivity, profile

    from ultravox_torch.models import lora
    from ultravox_torch.ops.kernels import flash_attention as fl
    from ultravox_torch.ops.mel import log_mel_spectrogram
    from ultravox_torch.training import train_step as ts

    cfg = _flagship_config(tc)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = uv.init_params(cfg, gen, torch.bfloat16, dev)
    params = lora.apply_lora_to_model(
        params, tc.LoraConfig(), tc.LoraConfig(r=8, lora_alpha=8.0, target_modules=("q_proj", "v_proj")),
        gen)
    opt = ts.make_optimizer(1e-4, warmup_steps=0, total_steps=100)
    holder = {}
    holder["state"], template = ts.init_train_state(params, opt, TRAINABLE, device=dev)
    del params
    step = ts.make_train_step(cfg, tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE), opt,
                              template, remat=True, attn_impl="flash", vocab_chunk=256)
    B, mel_frames = 8, 1000
    n_tok = mel_frames // 2 // 8
    T, T2 = 64 + n_tok + 64, 128
    rng = np.random.default_rng(SEED + 6)
    labels = np.full((B, T), -100, np.int64)
    labels[:, -40:] = rng.integers(1, cfg.vocab_size, (B, 40))
    alt_labels = np.full((B, T2), -100, np.int64)
    alt_labels[:, -40:] = labels[:, -40:]
    mel = log_mel_spectrogram(torch.from_numpy(_audio(B, 10.0, rng)).to(dev))
    if mel.shape != (B, 80, mel_frames):
        _fail(f"phase 6: expected mel (8, 80, 1000), got {tuple(mel.shape)}")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in {
        "input_ids": rng.integers(1, cfg.vocab_size, (B, T)),
        "attention_mask": np.ones((B, T), np.int64),
        "labels": labels,
        "alt_input_ids": rng.integers(1, cfg.vocab_size, (B, T2)),
        "alt_attention_mask": np.ones((B, T2), np.int64),
        "alt_labels": alt_labels,
        "audio_lens": np.full((B,), mel_frames, np.int32),
        "audio_token_len": np.full((B,), n_tok, np.int32),
        "audio_token_start_idx": np.full((B,), 4, np.int32),
        "audio_chunk_batch_idx": np.arange(B, dtype=np.int32),
    }.items()}
    batch["audio_values"] = mel

    def one():
        holder["state"], m = step(holder["state"], batch)
        return m

    for _ in range(2):  # warm-up: allocator, optimizer state
        one()
    torch.cuda.synchronize()

    n_steps = 5
    L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
    fwd_per_step, bwd_per_step = 2 * L_enc + 3 * L_dec, L_enc + L_dec
    fl.flash_attention.launches = fl.flash_attention.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, enqueue, metrics = [], [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(one())
        enqueue.append(time.perf_counter() - t0)  # the host's part: the step never waits
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"flash_attention": fl.flash_attention.launches,
                "flash_attention_bwd": fl.flash_attention.bwd_launches}
    want = {"flash_attention": n_steps * fwd_per_step,
            "flash_attention_bwd": n_steps * bwd_per_step * fl.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"launches, {n_steps} train steps: {launches} expected {want} ({fwd_per_step} forward "
          f"calls and {bwd_per_step} backward calls x {fl.BWD_LAUNCHES} kernels per step)",
          flush=True)
    if launches != want:
        _fail(f"phase 6: flash_attention launches {launches}, expected {want}")
    vals = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(vals):
        print(f"train step {i}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} "
              f"param_norm {m['param_norm']:.6f} ({times[i] * 1e3:.3f} ms)", flush=True)
        if not (np.isfinite(m["loss"]) and m["grad_norm"] > 0 and np.isfinite(m["grad_norm"])):
            _fail(f"phase 6: step {i} has loss {m['loss']} and grad_norm {m['grad_norm']}")
    step_s = float(np.median(times))
    flops = _train_step_flops(cfg, B, T, T2, mel_frames)
    mfu = flops / step_s / BF16_FLOPS
    enqueue_s = float(np.median(enqueue))
    print(f"train step (B {B}, 10 s audio, T {T}, T2 {T2}): median {step_s * 1e3:.3f} ms, "
          f"{B / step_s:.3f} samples/s, model FLOPs {flops / 1e12:.3f} T per step, MFU "
          f"{100 * mfu:.2f}% of 989 TFLOP/s, peak memory {peak:.3f} GB; the host returns from "
          f"the step after {enqueue_s * 1e3:.3f} ms (median) of queueing it", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    evs, annotated_ms = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    runtime_launches = sum(e.count for e in prof.key_averages()
                           if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    print(f"train step profile: device busy {busy_ms:.3f} ms of {traced_ms:.3f} ms traced "
          f"({100 * busy_ms / traced_ms:.1f}% busy; the optimizer's annotation span "
          f"{annotated_ms:.3f} ms, not counted); {sum(e.count for e in evs)} device "
          f"kernels, {runtime_launches} kernel launch calls on the host", flush=True)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)
    flash_ms = {name: sum(e.self_device_time_total for e in evs if f"::{name}<" in e.key) / 1e3
                for name in ("flash_fwd_mma_kernel", "flash_delta_mma_kernel",
                             "flash_dkdv_mma_kernel", "flash_dq_mma_kernel")}
    print(f"train step profile: flash_attention kernels {flash_ms} ms, "
          f"{sum(flash_ms.values()):.3f} ms in all", flush=True)

    sites = _sync_sites(one)
    torch.cuda.synchronize()
    print(f"train step: {len(sites)} host waits for the card inside a step {sorted(set(sites))}",
          flush=True)
    if sites:
        _fail(f"phase 6: a train step waits for the card at {sorted(set(sites))}")
    vs_plain = _flash_loss_vs_plain(cfg, tc, uv, ts, fl, holder["state"], template, batch)
    result = {
        "step_ms_median": step_s * 1e3, "step_ms": [t * 1e3 for t in times],
        "samples_per_s": B / step_s, "model_tflop_per_step": flops / 1e12, "mfu": mfu,
        "host_enqueue_ms_median": enqueue_s * 1e3, "host_enqueue_ms": [t * 1e3 for t in enqueue],
        "peak_memory_gb": peak, "device_busy_ms": busy_ms, "traced_ms": traced_ms,
        "device_busy_share": busy_ms / traced_ms, "runtime_launches": runtime_launches,
        "flash_kernels_ms": flash_ms, "flash_kernel_vs_plain": vs_plain,
        "losses": [m["loss"] for m in vals], "grad_norms": [m["grad_norm"] for m in vals],
        "top_kernels": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    }
    return result, launches


# Bounds on the flagship KL loss and its gradient norm through the bf16
# flash kernels against the same call through _FlashPlain: the model runs
# in bf16 (8-bit significands) through 28 attention layers forward and 28
# back, and each kernel output may differ from the plain one by a few ulps
# (FLASH_RMS_TOL), so the two calls agree to about bf16 precision, not to
# fp32's. 2^-6 relative for the loss, 2^-4 for the gradient norm.
# The gradients themselves, leaf by leaf: the norm of their difference
# within 2^-3 of the plain gradient's norm (phase 6 shows about 2^-4.6).
FLASH_E2E_LOSS_RTOL = 2.0**-6
FLASH_E2E_GRAD_RTOL = 2.0**-4
FLASH_E2E_GRAD_DIFF_RTOL = 2.0**-3


def _flash_loss_vs_plain(cfg, tc, uv, ts, fl, state, template, batch, lc=None,
                         phase="phase 6"):
    """One forward and backward of the flagship loss (``lc``, by default
    KL; remat, vocab_chunk 256) on ``batch`` and ``state`` through the bf16
    flash kernels, then the same call with ``_FlashPlain`` swapped in for
    the kernels for that call only. Loss, the trainable leaves' gradient
    norm and the norm of the gradients' difference within
    FLASH_E2E_LOSS_RTOL / FLASH_E2E_GRAD_RTOL / FLASH_E2E_GRAD_DIFF_RTOL.
    Phase 6 runs it on its batch and state, phase 12 on the loop's first
    batch and initial state."""
    lc = lc or tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE)

    def loss_and_grads():
        params = ts.merge_params(template, state.trainable, state.frozen)
        loss = uv.ultravox_loss(params, cfg, batch, lc, remat=True, attn_impl="flash",
                                vocab_chunk=256)
        return float(loss.detach()), torch.autograd.grad(loss, list(state.trainable.values()))

    before = fl.flash_attention.launches
    loss_k, grads_k = loss_and_grads()
    if fl.flash_attention.launches == before:
        _fail(f"{phase}: the kernel's loss call launched no flash_attention kernel")
    kernel_fn = fl._FlashKernel
    fl._FlashKernel = fl._FlashPlain
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        fl._FlashKernel = kernel_fn
    norm_k = float(ts.global_norm(grads_k, grads_k))
    norm_p = float(ts.global_norm(grads_p, grads_p))
    diff = float(ts.global_norm([a - b for a, b in zip(grads_k, grads_p)], grads_k))
    out = {"loss_kernel": loss_k, "loss_plain": loss_p, "grad_norm_kernel": norm_k,
           "grad_norm_plain": norm_p, "grad_diff_norm": diff,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_norm_rel_err": abs(norm_k - norm_p) / norm_p, "grad_diff_rel": diff / norm_p}
    print(f"{phase} train loss, flash kernels vs _FlashPlain: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {out['loss_rel_err']:.3g}, tol {FLASH_E2E_LOSS_RTOL:.3g}); grad norm "
          f"{norm_k:.6f} vs {norm_p:.6f} (rel {out['grad_norm_rel_err']:.3g}, tol "
          f"{FLASH_E2E_GRAD_RTOL:.3g}); |g_kernel - g_plain| {diff:.4g} ({diff / norm_p:.3g} of "
          f"|g_plain|, tol {FLASH_E2E_GRAD_DIFF_RTOL:.3g})", flush=True)
    if not (np.isfinite(loss_k) and out["loss_rel_err"] <= FLASH_E2E_LOSS_RTOL):
        _fail(f"{phase}: the loss through the flash kernels {loss_k} vs the plain version's "
              f"{loss_p}")
    if not (np.isfinite(norm_k) and out["grad_norm_rel_err"] <= FLASH_E2E_GRAD_RTOL):
        _fail(f"{phase}: the gradient norm through the flash kernels {norm_k} vs the plain "
              f"version's {norm_p}")
    if not (np.isfinite(diff) and out["grad_diff_rel"] <= FLASH_E2E_GRAD_DIFF_RTOL):
        _fail(f"{phase}: the gradients through the flash kernels differ from the plain "
              f"version's by {diff} against a norm of {norm_p}")
    return out


def _scan_tokens(engine, batch, n_steps: int, attn_impl: str) -> torch.Tensor:
    """Greedy (B, n_steps + 1) tokens of the engine's prefill and first
    token, then one segmented_decode_scan of n_steps."""
    from ultravox_torch.inference.engine import _cache_bucket
    from ultravox_torch.models.decoder import segmented_decode_scan

    def greedy(logits):
        return logits.argmax(-1).to(torch.int32)

    tb = {k: torch.as_tensor(v).to(engine.device) for k, v in engine.pad_batch(batch).items()}
    B, T = tb["input_ids"].shape
    with torch.inference_mode():
        cache = engine._ensure_cache(None, B, _cache_bucket(T + n_steps + 1, engine.max_cache_len))
        logits, cache, lens = engine._prefill(tb, cache, 0)
        return segmented_decode_scan(
            engine.params["language_model"], engine.cfg.text_config, cache, lens, greedy(logits),
            n_steps=n_steps, sample_fn=greedy, attn_impl=attn_impl,
        ).cpu()


def _small_parity(tc, uv, TEngine, dev):
    """Phase 3: kernel paths on the card vs plain paths on the CPU, fp32,
    greedy tokens identical. For each config: generate (fused encoder and
    prefill kernels, decode kernel), generate_fused, and the segmented scan
    with the segment kernel on the card against its plain form on the CPU.
    The configs: the llama-family speech model, and a gemma-3-style decoder
    (window 8 on every other layer, qk-norm, post-norms, local rope, final
    softcap) whose local layers send the runtime window into both decode
    kernels."""
    from ultravox_torch.ops.kernels.decode_attention import decode_attention
    from ultravox_torch.ops.kernels.segment_attention import segment_tail_attention

    (llama, llama_batch), (gemma, gemma_batch) = _small_models(tc)
    for name, cfg, batch in (("llama", llama, llama_batch), ("gemma3", gemma, gemma_batch)):
        params = _small_params(uv, cfg)
        toks = {}
        for device in ("cpu", dev):
            eng = TEngine(params, cfg, max_cache_len=128, cache_dtype=torch.float32,
                          encoder_attn_impl="fused", prefill_attn_impl="fused",
                          decode_attn_impl="kernel", device=device)
            before = (decode_attention.launches, segment_tail_attention.launches)
            toks[device] = {
                "generate": eng.generate(batch, max_new_tokens=12).token_ids,
                "generate_fused": eng.generate_fused(batch, max_new_tokens=12).token_ids,
                "segmented_decode_scan": _scan_tokens(
                    eng, batch, 11, "xla" if device == "cpu" else "kernel").tolist(),
            }
            if device != "cpu" and not (decode_attention.launches > before[0]
                                        and segment_tail_attention.launches > before[1]):
                _fail(f"small parity {name}: a decode kernel was not launched on the card")
        for path, cpu in toks["cpu"].items():
            print(f"small parity {name} {path}: cpu {cpu} gpu {toks[dev][path]}", flush=True)
            if cpu != toks[dev][path]:
                _fail(f"{name} {path}: greedy tokens on the card differ from the CPU's")
        _small_serving_parity(name, params, cfg, [_row(batch, i) for i in range(2)], dev)
        if "audio_values" in batch:
            _small_flash_encoder_parity(params, cfg, batch, TEngine, dev)


# larger weights make greedy tokens vary (the encoder's only 2x: larger
# attention logits there amplify fp32 summation-order noise)
SMALL_SCALE = {"audio_tower": 2.0, "projector": 8.0, "language_model": 8.0}


def _small_models(tc):
    """Phase 3's small configs, each with its batch: the llama-family speech model (2 rows of 1.5 s audio
    at position 4 of 32 tokens) and a gemma-3-style decoder (window 8 on
    every other layer, qk-norm, post-norms, local rope, final softcap;
    24-token rows, the second padded from 20)."""
    from ultravox_torch.ops.mel import log_mel_spectrogram_np

    text = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True)
    llama = tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(d_model=128, num_layers=2, num_heads=2, ffn_dim=256),
        text_config=tc.DecoderConfig(**text), hidden_size=256, projector_ln_mid=True,
    )
    gemma = tc.UltravoxConfig(text_config=tc.DecoderConfig(**dict(
        text, arch="gemma3", num_layers=4, sliding_window=8, sliding_window_pattern=2,
        qk_norm=True, use_post_norms=True, scale_embeddings=True, rope_theta=1e6,
        rope_local_base_freq=10000.0, final_logit_softcapping=30.0,
        hidden_act="gelu_pytorch_tanh")), llm_only_training=True)
    rng = np.random.default_rng(SEED)
    mel = torch.from_numpy(np.stack([log_mel_spectrogram_np(a) for a in _audio(2, 1.5, rng)]))
    ids = rng.integers(1, 512, (2, 24)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    llama_batch = _batch(llama, mel, 32, rng)
    return (llama, llama_batch), (gemma, {"input_ids": ids, "attention_mask": mask})


def _small_params(uv, cfg):
    """A small config's seeded fp32 parameters, scaled by SMALL_SCALE."""
    params = uv.init_params(cfg, torch.Generator().manual_seed(SEED))
    return {k: _scale(v, SMALL_SCALE[k]) for k, v in params.items()}


def _small_flash_encoder_parity(params, cfg, batch, TEngine, dev):
    """encoder_attn_impl="flash" in both engines, fp32: a generate and a
    paged ServingEngine (each row one request) on the card give the CPU's
    greedy tokens; on the card flash_attention's forward kernel runs once
    per encoder layer per encoder call (1 generate + 2 admissions) and the
    fused encoder's kernels (#1-#3) not at all."""
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.ops.kernels import flash_attention as fl
    from ultravox_torch.ops.kernels import fused_attention as fa
    from ultravox_torch.ops.kernels import layer_norm as ln_mod

    fused = (ln_mod.fused_layer_norm, fa.ln_qkv_head_fused, fa.attention_headmajor)
    requests = [_row(batch, i) for i in range(2)]
    toks = {}
    for device in ("cpu", dev):
        fl.flash_attention.launches = 0
        before = [c.launches for c in fused]
        eng = TEngine(params, cfg, max_cache_len=128, cache_dtype=torch.float32,
                      encoder_attn_impl="flash", prefill_attn_impl="fused",
                      decode_attn_impl="kernel", device=device)
        gen = eng.generate(batch, max_new_tokens=12).token_ids
        srv = ServingEngine(
            params, cfg, num_slots=4, max_seq_len=128, cache_dtype=torch.float32,
            cache_mode="paged", page_size=16, prefill_len_buckets=(64, 128),
            mel_len_buckets=(400,), prefill_chunk_tokens=16, decode_block_steps=4,
            encoder_attn_impl="flash", prefill_attn_impl="fused", decode_attn_impl="kernel",
            block_attn_impl="kernel", device=device)
        srv.start()
        try:
            served = [ids for ids, _, _ in _serve(srv, requests, 12)]
        finally:
            srv.stop()
        toks[device] = {"generate": gen, "serving": served}
        if device != "cpu":
            want = cfg.audio_config.num_layers * (1 + len(requests))
            print(f"small parity flash encoder: flash_attention forward launches "
                  f"{fl.flash_attention.launches} (expected {want}), fused encoder kernels "
                  f"{[c.launches - n for c, n in zip(fused, before)]} (expected 0)", flush=True)
            if fl.flash_attention.launches != want:
                _fail(f"flash encoder: {fl.flash_attention.launches} flash_attention launches, "
                      f"expected {want}")
            if [c.launches for c in fused] != before:
                _fail("flash encoder: a kernel of the fused encoder was launched")
    for path, cpu in toks["cpu"].items():
        print(f"small parity flash encoder {path}: cpu {cpu} gpu {toks[dev][path]}", flush=True)
        if cpu != toks[dev][path]:
            _fail(f"flash encoder {path}: greedy tokens on the card differ from the CPU's")


def _row(batch, i: int):
    """Row i of a collated batch as a one-request batch."""
    out = {k: batch[k][i: i + 1] for k in ("input_ids", "attention_mask")}
    if "audio_values" in batch:
        n = batch["audio_chunk_batch_idx"] == i
        out.update({k: batch[k][n] for k in (
            "audio_values", "audio_lens", "audio_token_len", "audio_token_start_idx")})
        out["audio_chunk_batch_idx"] = np.zeros((int(n.sum()),), np.int32)
    return out


def _serve(engine, batches, max_tokens: int, loras=None, options=None, events=None):
    """Submit every batch at once (request i on adapter loras[i], with the
    submit options options[i]); (tokens, finish reason, ttft_s) of each.
    ``events``, a list, receives each request's token events."""
    loras = loras or [None] * len(batches)
    options = options or [{}] * len(batches)
    reqs = [engine.submit(dict(b), max_tokens=max_tokens, lora=n, **o)
            for b, n, o in zip(batches, loras, options)]
    if not engine._running:
        engine.start()  # queued before the loop starts: a fixed schedule
    out = []
    for r in reqs:
        ids, evs, end = [], [], None
        for ev in engine.stream(r, timeout=600):
            if ev.token_id is None:
                end = ev
                break
            ids.append(ev.token_id)
            evs.append(ev)
        out.append((ids, end.finish_reason, end.ttft_s))
        if events is not None:
            events.append(evs)
    return out


def _check_pages(engine, label: str) -> None:
    """Paged mode: every page owned once or free, and the tables agree."""
    if not engine.paged:
        return
    owned = [p for pages in engine._slot_pages for p in pages]
    ok = (len(owned) + len(engine._free_pages) == engine.num_pages
          and len(set(owned) | set(engine._free_pages)) == engine.num_pages)
    for slot, pages in enumerate(engine._slot_pages):
        ok &= engine._table_np[slot, : len(pages)].tolist() == pages
        ok &= bool((engine._table_np[slot, len(pages):] == engine.num_pages).all())
    if not ok:
        _fail(f"{label}: page accounting broken")


def _small_serving_parity(name, params, cfg, requests, dev, audio_buckets=(400,)):
    """The ServingEngine on the card against the same engine on the CPU,
    fp32, greedy tokens identical, in slots and paged modes (pages of 16, a
    pool smaller than the slots' tokens) with both block attentions. Each
    card run must launch its mode's kernels. ``audio_buckets``: the
    engine's padded audio lengths (mel frames, or samples for wav2vec2)."""
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.ops.kernels import decode_attention as da
    from ultravox_torch.ops.kernels import paged_attention as pa
    from ultravox_torch.ops.kernels import paged_gather as pg
    from ultravox_torch.ops.kernels import segment_attention as sa

    kernels = {
        ("slots", "xla"): (da.decode_attention,),
        ("slots", "kernel"): (da.decode_attention, sa.segment_tail_attention),
        ("paged", "xla"): (pa.paged_decode_attention, pg.gather_pages),
        ("paged", "kernel"): (pa.paged_decode_attention, sa.paged_segment_tail_attention),
    }
    for (mode, impl), counters in kernels.items():
        toks = {}
        for device in ("cpu", dev):
            before = [c.launches for c in counters]
            srv = ServingEngine(
                params, cfg, num_slots=4, max_seq_len=128, cache_dtype=torch.float32,
                cache_mode=mode, page_size=16, num_pages=20 if mode == "paged" else None,
                prefill_len_buckets=(64, 128), mel_len_buckets=audio_buckets,
                prefill_chunk_tokens=16, decode_block_steps=4, encoder_attn_impl="fused",
                prefill_attn_impl="fused", decode_attn_impl="kernel", block_attn_impl=impl,
                device=device)
            srv.start()
            try:
                out = _serve(srv, requests, 12)
                _check_pages(srv, f"small serving {name} {mode}/{impl}")
            finally:
                srv.stop()
            toks[device] = [ids for ids, _, _ in out]
            if any(f != "length" for _, f, _ in out):
                _fail(f"small serving {name} {mode}/{impl}: finish reasons {[o[1] for o in out]}")
            if device != "cpu" and not all(c.launches > n for c, n in zip(counters, before)):
                _fail(f"small serving {name} {mode}/{impl}: a kernel of the mode was not launched")
        print(f"small serving {name} {mode}/{impl}: cpu {toks['cpu']} gpu {toks[dev]}", flush=True)
        if toks["cpu"] != toks[dev]:
            _fail(f"small serving {name} {mode}/{impl}: greedy tokens on the card differ from the CPU's")


def _adapters(params, dtype, gen, text_scale, audio_scale, r):
    """Adapters "a" and "b" in the v0.6 recipe's targets: text LoRA on the
    decoder's q/v/gate and audio LoRA on the encoder's q/v, rank r, with
    lora_b drawn at the given scales so that each adapter moves the output."""
    from ultravox_torch.models import lora as lora_lib
    from ultravox_torch.models.config import LoraConfig

    out = {}
    for name in ("a", "b"):
        tree = {}
        for tower, targets, table, sc in (
            ("language_model", ("q_proj", "v_proj", "gate_proj"), lora_lib.DECODER_TARGETS,
             text_scale),
            ("audio_tower", ("q_proj", "v_proj"), lora_lib.ENCODER_TARGETS, audio_scale),
        ):
            t = lora_lib.add_lora(params[tower], LoraConfig(r=r, target_modules=targets), gen,
                                  table, dtype)
            for tgt in targets:
                b = t["layers"][tgt]["lora_b"]
                t["layers"][tgt]["lora_b"] = (sc * torch.randn(
                    b.shape, generator=gen, device=gen.device)).to(dtype)
            tree[tower] = t
        out[name] = tree
    return out


# Bounds on int8 prefill logits, card against CPU: relative RMS over the
# logits, and the largest difference against the largest logit. These are
# the bounds the CPU tests hold the port to against the JAX package.
INT8_RMS_TOL = 0.05
INT8_ABS_TOL = 0.1


def _small_lora_int8_parity(tc, uv, TEngine, dev):
    """Phase 3, continued: the small llama speech model with multi-LoRA and
    int8. (1) The ServingEngine with two adapters (text LoRA on q/v/gate,
    audio LoRA on the fused encoder's q/v) beside the base model, in slots
    and paged modes, fp32: greedy tokens on the card equal the CPU's, and
    the card ran qkv_head_transpose. (2) GenerationEngine(quantize="int8")
    on weights at twice the init scale, with a bf16 cache (the kernels take
    one dtype for q and the cache, and int8 trees run bf16 activations):
    every int8 projection of the engine's tree on the card against the CPU
    (w8a8 bit-equal, its accumulators being exact; w8a16 within 4 bf16 ulps
    of the largest output, the fp32 sums in another order), then the
    prefill logits within INT8_RMS_TOL and INT8_ABS_TOL of the CPU's, beside
    two faults planted on the CPU (w8a16 at every row count, fp32 scales),
    and greedy token agreement printed."""
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.models import decoder as dec_lib
    from ultravox_torch.models import lora as lora_lib
    from ultravox_torch.ops.kernels import fused_attention as fa
    from ultravox_torch.ops.mel import log_mel_spectrogram_np

    cfg = tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(d_model=128, num_layers=2, num_heads=2, ffn_dim=256),
        text_config=tc.DecoderConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                                     tie_word_embeddings=True),
        hidden_size=256, projector_ln_mid=True,
    )
    rng = np.random.default_rng(SEED + 3)
    mel = torch.from_numpy(np.stack([log_mel_spectrogram_np(a) for a in _audio(2, 1.5, rng)]))
    batch = _batch(cfg, mel, 32, rng)
    base = uv.init_params(cfg, torch.Generator().manual_seed(SEED))
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 8.0}
    params = {k: _scale(v, scale[k]) for k, v in base.items()}
    adapters = _adapters(params, torch.float32, torch.Generator().manual_seed(SEED + 4), 0.5, 0.1, 4)
    requests = [_row(batch, i) for i in range(2)] * 2
    names = [None, "a", "b", "a"]
    for mode in ("slots", "paged"):
        toks = {}
        for device in ("cpu", dev):
            before = fa.qkv_head_transpose.launches
            srv = ServingEngine(
                params, cfg, num_slots=4, max_seq_len=128, cache_dtype=torch.float32,
                cache_mode=mode, page_size=16, prefill_len_buckets=(64, 128),
                mel_len_buckets=(400,), prefill_chunk_tokens=16, decode_block_steps=4,
                encoder_attn_impl="fused", prefill_attn_impl="fused", decode_attn_impl="kernel",
                block_attn_impl="kernel", lora_adapters=adapters, device=device)
            srv.start()
            try:
                out = _serve(srv, requests, 12, names)
                _check_pages(srv, f"small multi-LoRA serving {mode}")
            finally:
                srv.stop()
            toks[device] = [ids for ids, _, _ in out]
            if device != "cpu" and fa.qkv_head_transpose.launches <= before:
                _fail(f"small multi-LoRA serving {mode}: qkv_head_transpose was not launched")
        print(f"small multi-LoRA serving {mode}: cpu {toks['cpu']} gpu {toks[dev]}", flush=True)
        if toks["cpu"] != toks[dev] or any(len(t) != 12 for t in toks[dev]):
            _fail(f"small multi-LoRA serving {mode}: greedy tokens on the card differ from the CPU's")
        if toks["cpu"][0] == toks["cpu"][1] == toks["cpu"][2]:
            _fail("small multi-LoRA serving: the adapters do not change the tokens")

    calm = dict(base, language_model=_scale(base["language_model"], 2.0))

    def int8_engine(device):
        return TEngine(calm, cfg, max_cache_len=128, cache_dtype=torch.bfloat16, quantize="int8",
                       encoder_attn_impl="fused", prefill_attn_impl="fused",
                       decode_attn_impl="kernel", device=device)

    def prefill_logits(eng):
        tb = {k: torch.as_tensor(v).to(eng.device) for k, v in eng.pad_batch(batch).items()}
        with torch.inference_mode():
            cache = eng._ensure_cache(None, tb["input_ids"].shape[0], 128)
            return eng._prefill(tb, cache, 0)[0].float().cpu()

    engines = {device: int8_engine(device) for device in ("cpu", dev)}
    # every int8 projection of layer 0 and the head, in both regimes
    g = torch.Generator().manual_seed(SEED + 5)
    projs = [(f"{tower} {name}", {k: v[0] for k, v in leaf.items()})
             for tower in ("audio_tower", "language_model")
             for name, leaf in engines["cpu"].params[tower]["layers"].items()
             if isinstance(leaf, dict) and "kernel_q" in leaf]
    projs.append(("lm_head", engines["cpu"].params["language_model"]["lm_head"]))
    for label, p in projs:
        for rows in (2, 64):
            x = torch.randn((rows, p["kernel_q"].shape[0]), generator=g).bfloat16()
            ref = lora_lib.proj_apply(x, p)
            out = lora_lib.proj_apply(x.to(dev), {k: v.to(dev) for k, v in p.items()}).cpu()
            err = float((out.float() - ref.float()).abs().max())
            tol = _bf16_tol(ref) if rows <= lora_lib.W8A16_MAX_ROWS else 0.0
            if not err <= tol:
                _fail(f"int8 {label} at {rows} rows: card differs from the CPU by {err} > {tol}")
    print(f"small int8 projections: {len(projs)} on the card against the CPU, w8a8 bit-equal, "
          f"w8a16 within 4 bf16 ulps", flush=True)
    logits = {device: prefill_logits(eng) for device, eng in engines.items()}
    toks = {device: eng.generate(batch, max_new_tokens=12).token_ids
            for device, eng in engines.items()}
    ref = logits["cpu"]
    quantize = dec_lib._quantize_kernel

    def fp32_scales(kernel, axis=-2):
        k32 = kernel.float()
        return quantize(kernel, axis)[0], k32.abs().amax(dim=axis, keepdim=True).clamp(min=1e-8) / 127.0

    planted = {}
    for fault, (mod, attr, value) in {
        "w8a16 at every row count": (lora_lib, "W8A16_MAX_ROWS", 1 << 30),
        "fp32 scales": (dec_lib, "_quantize_kernel", fp32_scales),
    }.items():
        kept = getattr(mod, attr)
        setattr(mod, attr, value)
        try:
            planted[fault] = _rel_rms(prefill_logits(int8_engine("cpu")), ref)
        finally:
            setattr(mod, attr, kept)
    rms = _rel_rms(logits[dev], ref)
    err = float((logits[dev] - ref).abs().max()) / float(ref.abs().max())
    same = sum(a == b for r, q in zip(toks["cpu"], toks[dev]) for a, b in zip(r, q))
    print(f"small int8 generate: prefill logits card vs cpu relative RMS {rms:.4g} (tol "
          f"{INT8_RMS_TOL}), max_abs_err {err:.4g} of the largest (tol {INT8_ABS_TOL}); planted "
          f"faults on the cpu read relative RMS {planted}; greedy tokens equal {same} of "
          f"{sum(len(r) for r in toks['cpu'])}: cpu {toks['cpu']} gpu {toks[dev]}", flush=True)
    if not (rms <= INT8_RMS_TOL and err <= INT8_ABS_TOL):
        _fail(f"small int8 generate: prefill logits on the card differ from the CPU's: relative "
              f"RMS {rms}, max_abs_err {err} of the largest")


def _counted_run(counters, label, fn, expected):
    """fn() with every count set to 0 just before and read just after, each
    against ``expected`` (0 where it names none): (fn's result, start and
    end on the host clock, the launches)."""
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {name: c.launches for name, c in counters.items()}
    want = {name: expected.get(name, 0) for name in counters}
    print(f"launches, {label}: {launches} expected {want}", flush=True)
    for name, n in launches.items():
        if n != want[name]:
            _fail(f"{name} launched {n} times in {label}, expected {want[name]}")
    return out, t_start, t_end, launches


def _scale(tree, f):
    if isinstance(tree, dict):
        return {k: _scale(v, f) for k, v in tree.items()}
    if isinstance(tree, list):  # the wav2vec2 conv stack
        return [_scale(v, f) for v in tree]
    return tree * f if tree.ndim >= 2 else tree


def main() -> None:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ultravox_torch.inference.engine import GenerationEngine
    from ultravox_torch.models import config as tc
    from ultravox_torch.models import ultravox as uv
    from ultravox_torch.ops.kernels import _build
    from ultravox_torch.ops.kernels import decode_attention as da
    from ultravox_torch.ops.kernels import decode_matmul as dm
    from ultravox_torch.ops.kernels import encoder_attn_probe as eap
    from ultravox_torch.ops.kernels import flash_attention as fl
    from ultravox_torch.ops.kernels import fused_attention as fa
    from ultravox_torch.ops.kernels import layer_norm as ln_mod
    from ultravox_torch.ops.kernels import paged_attention as pa
    from ultravox_torch.ops.kernels import paged_gather as pg
    from ultravox_torch.ops.kernels import segment_attention as sa
    from ultravox_torch.ops.mel import log_mel_spectrogram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s total", flush=True)
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.2f} s", flush=True)
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    for name in MMA_BUILDS:
        _check_mma_build(_build, name, built[name])
    _check_split_build(built)

    print(f"phase 1: {time.perf_counter() - t_script:.2f} s", flush=True)
    if sys.argv[1:] == ["--phases", "12,14"]:  # a developer's short run: no result line
        _phases_12_14(tc, uv, dev)
        return
    if sys.argv[1:3] == ["--phases", "15"] and len(sys.argv) in (3, 5):
        _phase15_only(tc, uv, dev, sys.argv[4] if sys.argv[3:4] == ["--baseline"] else None)
        return
    if sys.argv[1:] == ["--phases", "16"]:
        _phase16_only(tc, uv, dev)
        return
    if sys.argv[1:] == ["--phases", "17"]:
        _phase17_only(tc, uv, dev)
        return

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    _check_attention(fa, eap, dev)
    rows = (_check_kernels(fa, ln_mod, dev) + _check_decode_kernels(da, sa, dev)
            + _check_paged_kernels(pa, pg, sa, da, dev) + _check_flash(fl, dev)
            + _check_unwired_kernels(fa, dm, dev))
    t9_rows = _check_spec_verify_kernels(sa, dev)
    rows += t9_rows
    print(f"phase 2: {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. small end-to-end parity
    t0 = time.perf_counter()
    _small_parity(tc, uv, GenerationEngine, dev)
    _small_train_parity(tc, dev)
    _small_lora_int8_parity(tc, uv, GenerationEngine, dev)
    print(f"phase 3: {time.perf_counter() - t0:.2f} s", flush=True)

    # 4. main path at flagship widths
    t_phase4 = time.perf_counter()
    cfg = _flagship_config(tc)
    t0 = time.perf_counter()
    params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16, dev)
    engine = GenerationEngine(
        params, cfg, max_cache_len=1024, encoder_attn_impl="fused",
        prefill_attn_impl="fused", decode_attn_impl="kernel", device=dev,
    )
    del params
    torch.cuda.synchronize()
    wbytes = sum(_nbytes(t) for t in _leaves(engine.params))
    print(f"weights: {wbytes / 1e9:.3f} GB bf16, init {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(SEED)
    n_req, seconds, prompt_len, new_tokens = 4, 10.0, 128, 32
    steps = new_tokens - 1
    wav = torch.from_numpy(_audio(n_req, seconds, rng)).to(dev)
    mel = log_mel_spectrogram(wav)  # (4, 80, 1000) on the card
    batch = _batch(cfg, mel, prompt_len, rng)
    # warm-up: library handles, allocator, every path once
    engine.generate(batch, max_new_tokens=2)
    engine.generate_fused(batch, max_new_tokens=2)
    _scan_tokens(engine, batch, 1, "kernel")

    counters = {
        "fused_layer_norm": ln_mod.fused_layer_norm,
        "ln_qkv_head_fused": fa.ln_qkv_head_fused,
        "qkv_head_transpose": fa.qkv_head_transpose,
        "attention_headmajor": fa.attention_headmajor,
        "fused_attention": fa.fused_attention,
        "decode_attention": da.decode_attention,
        "segment_tail_attention": sa.segment_tail_attention,
        # launched by no engine (phases 4-7 expect 0 of each)
        "ln_matmul_gelu": fa.ln_matmul_gelu,
        "attn_out_proj_residual": fa.attn_out_proj_residual,
        "decode_matmul": dm.decode_matmul,
        "attn_v2": eap.attn_v2,
        "attn_nt": eap.attn_nt,
    }
    L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
    prefill = {
        "fused_layer_norm": L_enc, "ln_qkv_head_fused": L_enc,
        "attention_headmajor": L_enc, "fused_attention": L_dec,
    }

    def check_tokens(label, ids):
        if len(ids) != n_req or any(len(r) != new_tokens for r in ids):
            _fail(f"{label}: expected {n_req} x {new_tokens} tokens, got {[len(r) for r in ids]}")
        if any(not 0 <= t < cfg.vocab_size for r in ids for t in r):
            _fail(f"{label}: token id out of range")

    # 4.1 generate, decode through the decode_attention kernel
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    result, t_start, t_end, launches = _counted_run(
        counters, "generate(decode_attn_impl='kernel')",
        lambda: engine.generate(
            batch, max_new_tokens=new_tokens,
            token_callback=lambda step, toks, done: stamps.append(time.perf_counter())),
        dict(prefill, decode_attention=L_dec * steps),
    )
    ids = result.token_ids
    check_tokens("generate", ids)
    ttft_ms = (stamps[0] - t_start) * 1e3
    decode_tps = n_req * steps / (stamps[-1] - stamps[0])
    print(f"main path: {n_req} requests x {seconds:.0f} s audio, prompt {prompt_len}, "
          f"{new_tokens} greedy tokens; TTFT {ttft_ms:.3f} ms; decode {decode_tps:.2f} tok/s; "
          f"total {(t_end - t_start) * 1e3:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)

    # 4.2 generate_fused: one segmented scan with the plain merged attention,
    # as the JAX engine's generate_fused runs it
    fused, f_start, f_end, _ = _counted_run(
        counters, "generate_fused",
        lambda: engine.generate_fused(batch, max_new_tokens=new_tokens), prefill)
    check_tokens("generate_fused", fused.token_ids)
    fused_ttft_ms = _first_token_ms(engine, batch)
    fused_tps = n_req * steps / ((f_end - f_start) - fused_ttft_ms / 1e3)
    print(f"generate_fused: total {(f_end - f_start) * 1e3:.3f} ms; prefill to first token "
          f"{fused_ttft_ms:.3f} ms (timed apart); decode {fused_tps:.2f} tok/s", flush=True)

    # 4.3 the segmented scan through the segment_tail_attention kernel
    seg, s_start, s_end, seg_launches = _counted_run(
        counters, "segmented_decode_scan(attn_impl='kernel')",
        lambda: _scan_tokens(engine, batch, steps, "kernel"),
        dict(prefill, segment_tail_attention=L_dec * steps),
    )
    seg = seg.tolist()[:n_req]
    check_tokens("segmented scan", seg)
    seg_tps = n_req * steps / ((s_end - s_start) - fused_ttft_ms / 1e3)
    print(f"segmented scan (kernel): total {(s_end - s_start) * 1e3:.3f} ms; decode "
          f"{seg_tps:.2f} tok/s (prefill to first token as in generate_fused)", flush=True)
    for row in rows:
        if row["name"] in launches:
            row["launches"] = (seg_launches if row["name"] == "segment_tail_attention"
                               else launches)[row["name"]]
    paths = {"generate": ids, "generate_fused": fused.token_ids, "segmented scan": seg}
    for name, toks in paths.items():
        same = sum(a == b for r, s_ in zip(toks, ids) for a, b in zip(r, s_))
        print(f"first tokens, {name}: {[r[:8] for r in toks]} ({same} of "
              f"{n_req * new_tokens} equal to generate's)", flush=True)
    if len({tuple(r[0] for r in toks) for toks in paths.values()}) != 1:
        _fail("the first token differs between paths that share one prefill")

    _breakdown(engine, batch, new_tokens, {
        "generate": (t_end - t_start) * 1e3, "generate_fused": (f_end - f_start) * 1e3,
        "kernel scan": (s_end - s_start) * 1e3})

    print(f"phase 4: {time.perf_counter() - t_phase4:.2f} s", flush=True)

    # 5. the ServingEngine at flagship widths, on the same weights
    t0 = time.perf_counter()
    counters.update({
        "paged_decode_attention": pa.paged_decode_attention,
        "paged_segment_tail_attention": sa.paged_segment_tail_attention,
        "gather_pages": pg.gather_pages,
    })
    serving, serve_launches = _serving_main_path(engine, cfg, counters, prefill, dev)
    for row in rows:
        if row["name"] in serve_launches:
            row["launches"] = serve_launches[row["name"]]

    print(f"phase 5: {time.perf_counter() - t0:.2f} s", flush=True)

    # 6. the training step at flagship widths, on weights of its own
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training, train_launches = _train_main_path(tc, uv, dev)
    print(f"phase 6: {time.perf_counter() - t0:.2f} s", flush=True)
    for row in rows:
        if row["name"] in train_launches:
            row["launches"] = train_launches[row["name"]]
    torch.cuda.empty_cache()

    # 7. multi-LoRA and int8 at flagship widths, on phase 4's weights
    lora_int8, qkv_launches = _lora_int8_main_path(tc, uv, cfg, counters, batch, ids, wbytes, dev)
    for row in rows:
        if row["name"] == "qkv_head_transpose":
            row["launches"] = qkv_launches["lora paged+kernel"]
            row["launches_per_path"] = qkv_launches

    # 8. the encoder-attention probes' entry point
    probe_rows, probes = _probe_entry_point(eap, dev)
    rows += probe_rows

    # 9. a flagship checkpoint written, loaded and served with every option
    checkpoint, ckpt_launches = _checkpoint_main_path(tc, uv, cfg, counters, prefill, serving, dev)
    for row in rows:
        if row["name"] in ckpt_launches:
            row["launches_per_path"] = {"serving (a)": row["launches"],
                                        "checkpoint serving": ckpt_launches[row["name"]]}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    # 10. the voice path: streaming encode, HTTP and the voice WebSocket
    voice, voice_launches = _voice_main_path(tc, uv, cfg, counters, prefill, smi, dev)
    for row in rows:
        if row["name"] in voice_launches:
            row.setdefault("launches_per_path", {"main": row["launches"]})["voice http"] = (
                voice_launches[row["name"]])

    # 11. the front doors, main() and speculative decoding
    front_doors, t9 = _front_doors_main_path(tc, uv, cfg, counters, prefill, launches, smi, dev)
    for row in t9_rows:
        row["launches"] = t9[row["name"].split(" ")[0]]
        row["launches_note"] = "T = 9 launches in phase 11 (d)'s guard-off speculative run"

    # 12. the training loop: train() with checkpoints, validation and resume
    train_loop, loop_launches = _train_loop_main_path(
        tc, counters, training["step_ms_median"], smi, dev)
    for row in rows:
        if row["name"] in ("flash_attention", "flash_attention_bwd"):
            row["launches_per_path"] = {"train steps (phase 6)": row["launches"],
                                        "train loop (phase 12)": loop_launches[row["name"]]}

    # 13. the wav2vec2 tower at full width through every path that takes it
    wav2vec2, w2v_launches = _w2v_main_path(tc, uv, counters, smi, dev)
    for row in rows:
        for path, launched in w2v_launches.items():
            if row["name"] in launched and launched[row["name"]]:
                row.setdefault("launches_per_path", {"main": row["launches"]})[
                    f"wav2vec2 {path}"] = launched[row["name"]]

    # 14. several processes over NCCL: train(), resume and the eval CLI
    multiprocess, mp_launches = _multiprocess_main_path(tc, uv, cfg, counters, prefill,
                                                        train_loop, smi, dev)
    for row in rows:
        for path, launched in mp_launches.items():
            if launched.get(row["name"]):
                row.setdefault("launches_per_path", {"main": row["launches"]})[
                    f"multi-process {path} (phase 14)"] = launched[row["name"]]

    # 15. the tensor axis: two ranks on the card, trained and served sharded
    tensor, tp_launches = _tensor_main_path(tc, uv, _kernel_counters(), smi, dev)
    for row in rows:
        for path, launched in tp_launches.items():
            if launched.get(row["name"]):
                row.setdefault("launches_per_path", {"main": row["launches"]})[
                    f"tensor 2 {path} (phase 15, a rank)"] = launched[row["name"]]

    # 16. the pipe axis: two ranks on the card, the decoder stack in GPipe stages
    pipe, pp_launches = _pipe_main_path(tc, uv, _kernel_counters(), smi, dev)
    for row in rows:
        for path, launched in pp_launches.items():
            if launched.get(row["name"]):
                row.setdefault("launches_per_path", {"main": row["launches"]})[
                    f"pipe 2 {path} (phase 16, a rank)"] = launched[row["name"]]

    # 17. run_serving_eval's server and the host tools at the flagship width
    serving_eval, se_launches = _serving_eval_main_path(tc, uv, _kernel_counters(), smi, dev)
    for row in rows:
        if se_launches.get(row["name"]):
            row.setdefault("launches_per_path", {"main": row["launches"]})[
                "run_serving_eval (phase 17)"] = se_launches[row["name"]]

    print(f"chip_smoke: {time.perf_counter() - t_script:.2f} s in all", flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "kernels": rows, "ttft_ms": ttft_ms, "decode_tok_s": decode_tps,
        "fused_first_token_ms": fused_ttft_ms, "fused_decode_tok_s": fused_tps,
        "scan_kernel_decode_tok_s": seg_tps, "serving": serving, "training": training,
        "lora_int8": lora_int8, "probes": probes, "checkpoint": checkpoint, "voice": voice,
        "front_doors": front_doors, "train_loop": train_loop, "wav2vec2": wav2vec2,
        "multiprocess": multiprocess, "tensor": tensor, "pipe": pipe,
        "serving_eval": serving_eval, "total_s": time.perf_counter() - t_script,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def _serving_main_path(engine, cfg, counters, per_call, dev):
    """Phase 5: the ServingEngine at flagship widths on the weights of
    phase 4's engine. 8 greedy requests (10 s of audio spliced into a
    128-token prompt, 32 tokens each) on 4 slots: the first four prefill in
    two 64-token chunks each while the others wait (single decode steps),
    then 8-step blocks run in steady state. Three engines in turn, each
    warmed up on two other prompts, then with every launch count set to 0
    just before its 8 requests and checked just after against its own
    counters:

        blocks  = (decode steps - decode dispatches) / 7
        singles = dispatches - blocks
        single-step kernel = 16 x singles, block kernel = 16 x 8 x blocks,
        gather_pages = blocks (paged, gathered view),
        fused_attention = 16 x prefill chunks,
        each encoder kernel = its per-call count of phase 4 x admissions.

    Each engine then serves 8 other prompts under torch.profiler: the
    device's busy share, #3 + #4's time, and the split KV kernels' time and
    launches (#9 + #12 in (a), #9 in (b), #8 + #11 in (c)); a one-block KV
    kernel in the trace fails the run.

    Returns (metrics per engine, launches of the new kernels)."""
    import inspect

    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.ops.mel import log_mel_spectrogram

    n_req, seconds, prompt_len, new_tokens, K = 8, 10.0, 128, 32, 8
    L_dec = cfg.text_config.num_layers
    rng = np.random.default_rng(SEED + 5)
    mel = log_mel_spectrogram(torch.from_numpy(_audio(n_req, seconds, rng)).to(dev))
    batch = _batch(cfg, mel, prompt_len, rng)
    warm_ids = batch["input_ids"][:2] % (cfg.vocab_size - 1) + 1  # other prompts: no reuse
    warm = [_row(dict(batch, input_ids=warm_ids), i) for i in range(2)]
    requests = [_row(batch, i) for i in range(n_req)]
    with torch.inference_mode():
        ref = engine.generate(batch, max_new_tokens=new_tokens).token_ids
    fetch = ServingEngine._process_oldest_decode_inner
    lines, first = inspect.getsourcelines(fetch)
    fetch_lines = {(inspect.getsourcefile(fetch), first + i) for i in range(len(lines))}

    engines = (  # label, cache mode, block attention, single-step kernel, block kernel
        ("paged+kernel", "paged", "kernel", "paged_decode_attention", "paged_segment_tail_attention"),
        ("paged+xla", "paged", "xla", "paged_decode_attention", None),
        ("slots+kernel", "slots", "kernel", "decode_attention", "segment_tail_attention"),
    )
    metrics, new_launches, served = {}, {}, {}
    for label, mode, impl, single_k, block_k in engines:
        srv = ServingEngine(
            engine.params, cfg, num_slots=4, max_seq_len=2048, page_size=256, cache_mode=mode,
            prefill_chunk_tokens=64, decode_block_steps=K, encoder_attn_impl="fused",
            prefill_attn_impl="fused", decode_attn_impl="kernel", block_attn_impl=impl, device=dev,
        )
        srv.start()
        try:
            _serve(srv, warm, 12)
            # the same prompts again (now reused from the retained caches)
            # with CUDA sync debugging on: only the loop's fetch may wait
            # (the sleep lets the loop finish the bookkeeping that follows
            # each request's last event)
            sites = _sync_sites(lambda: (_serve(srv, warm, 12), time.sleep(0.5)))
            bad = [site for site in sites if site not in fetch_lines]
            print(f"serving {label}: {len(sites)} host waits for the card, "
                  f"{len(sites) - len(bad)} in the fetch, others at {sorted(set(bad))}", flush=True)
            if bad:
                _fail(f"serving {label}: the loop waits for the card outside its fetch at {bad}")
            for c in counters.values():
                c.launches = 0
            for stat in ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks"):
                setattr(srv, stat, 0)
            srv.stat_fetch_wait_s = srv.stat_dispatch_s = 0.0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = _serve(srv, requests, new_tokens)
            wall = time.perf_counter() - t0
            launches = {name: c.launches for name, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 1e9
            disp, steps, chunks = (srv.stat_decode_dispatches, srv.stat_decode_steps,
                                   srv.stat_prefill_chunks)
            dispatch_s, fetch_s = srv.stat_dispatch_s, srv.stat_fetch_wait_s
            _check_pages(srv, label)
            # a second, traced run of other prompts: the device's busy share
            trace = _traced_serve(srv, [_row(dict(batch, input_ids=batch["input_ids"][::-1].copy()),
                                             i) for i in range(n_req)], new_tokens, f"serving {label}")
        finally:
            srv.stop()
        del srv
        torch.cuda.empty_cache()

        encoder = {name: per_call[name] * n_req for name in
                   ("fused_layer_norm", "ln_qkv_head_fused", "attention_headmajor")}
        singles, blocks = _check_serving_launches(
            label, launches, counters, encoder, disp, steps, chunks, K, L_dec, single_k, block_k)
        for i, (ids, finish, _) in enumerate(out):
            if finish != "length" or len(ids) != new_tokens:
                _fail(f"serving {label}: request {i} finished {finish!r} with {len(ids)} tokens")
            if any(not 0 <= t < cfg.vocab_size for t in ids):
                _fail(f"serving {label}: token id out of range")
        ttft = sorted(t * 1e3 for _, _, t in out)
        agree = [sum(a == b for a, b in zip(ids, r)) for (ids, _, _), r in zip(out, ref)]
        served[label] = [ids for ids, _, _ in out]
        metrics[label] = {
            "ttft_p50_ms": float(np.median(ttft)), "ttft_max_ms": ttft[-1],
            "output_tok_s": n_req * new_tokens / wall, "wall_ms": wall * 1e3,
            "stat_dispatch_s": dispatch_s, "stat_fetch_wait_s": fetch_s, "peak_memory_gb": peak,
            "decode_dispatches": disp, "single_steps": singles, "blocks": blocks,
            "prefill_chunks": chunks, **trace,
            "tokens_equal_to_generate": agree,
            "first_tokens_equal_to_generate": sum(ids[0] == r[0] for (ids, _, _), r in zip(out, ref)),
        }
        print(f"serving {label}: {n_req} requests x {new_tokens} tokens in {wall * 1e3:.3f} ms "
              f"({n_req * new_tokens / wall:.2f} tok/s); TTFT p50 {np.median(ttft):.3f} ms, max "
              f"{ttft[-1]:.3f} ms; loop dispatch {dispatch_s * 1e3:.3f} ms, fetch wait "
              f"{fetch_s * 1e3:.3f} ms; peak memory {peak:.3f} GB; tokens equal to generate's "
              f"per request {agree} of {new_tokens} (first tokens "
              f"{metrics[label]['first_tokens_equal_to_generate']} of {n_req})", flush=True)
        for name in (single_k, block_k or "gather_pages"):
            if name in ("paged_decode_attention", "paged_segment_tail_attention", "gather_pages"):
                new_launches.setdefault(name, launches[name])
    for label in ("paged+xla", "slots+kernel"):
        same = sum(a == b for x, y in zip(served[label], served["paged+kernel"])
                   for a, b in zip(x, y))
        print(f"serving {label}: {same} of {n_req * new_tokens} tokens equal to paged+kernel's",
              flush=True)
    return metrics, new_launches


def _traced_serve(srv, requests, new_tokens, label, loras=None, options=None) -> dict:
    """Serve ``requests`` under torch.profiler: print the device's busy
    share of the traced wall, the top kernels, #2's and #3 + #4's time and
    the split KV kernels' time and launches (failing on a one-block KV
    kernel), and return them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _serve(srv, requests, new_tokens, loras, options)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    busy = busy_ms / (traced * 1e3)
    print(f"{label} profile: device busy {busy_ms:.3f} ms of {traced * 1e3:.3f} ms traced "
          f"({100 * busy:.1f}% busy)", flush=True)
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)
    # #3 and #4 launch one kernel (attention.cu's bf16 instantiation)
    attn = [e for e in evs if "attention_mma_kernel" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    print(f"{label} profile: #3 + #4 (attention_mma_kernel) {attn_ms:.3f} ms in "
          f"{sum(e.count for e in attn)} launches, of {busy_ms:.3f} ms busy", flush=True)
    # #2 launches one kernel a call (its tensor-core or CUDA-core instance)
    qkv = [e for e in evs if "ln_qkv_head" in e.key]
    qkv_ms, qkv_n = sum(e.self_device_time_total for e in qkv) / 1e3, sum(e.count for e in qkv)
    names = sorted({re.search(r"ln_qkv_head\w*(<[^>]*>)?", e.key).group(0) for e in qkv})
    print(f"{label} profile: #2 ln_qkv_head_fused ({names}) {qkv_ms:.3f} ms in {qkv_n} launches",
          flush=True)
    split = _split_kernel_ms(evs, label)
    return {"device_busy_share": busy, "device_busy_ms": busy_ms, "attention_kernel_ms": attn_ms,
            "ln_qkv_head_ms": qkv_ms, "ln_qkv_head_launches": qkv_n,
            "split_kernel_ms": {k: v[0] for k, v in split.items()},
            "split_kernel_launches": {k: v[1] for k, v in split.items()}}


def _lora_int8_main_path(tc, uv, cfg, counters, ref_batch, ref_ids, wbytes_bf16, dev):
    """Phase 7: multi-LoRA and int8 at flagship widths, on phase 4's weights
    (remade from the seed) and phase 4's batch. Two bf16 adapters "a" and
    "b", each with text LoRA r 8 on the decoder's q/v/gate and audio LoRA r
    8 on the encoder's q/v (the v0.6 targets), lora_b drawn at 0.05.

      (a) ServingEngine, paged + segment kernel as phase 5 (a): the 4 rows on
          the base model, then the same rows on a, b, a, b (8 requests x 32
          tokens; prefix reuse must not cross adapters). Every admission
          gathers its encoder adapter (slot 0 for the base model), so per
          admission 24 fused_layer_norm, 12 qkv_head_transpose, 12
          attention_headmajor and 0 ln_qkv_head_fused; the decoder's counts
          as in phase 5. The sync check of phase 5 runs with the adapters.
      (b) GenerationEngine(quantize="int8", fused encoder and prefill, decode
          kernel) on phase 4's batch: 24/12/12/0 encoder launches, 16
          fused_attention, 16 x 31 decode_attention per generate; TTFT,
          decode tok/s, weight bytes against bf16, tokens equal to phase 4's.
      (c) ServingEngine(quantize="int8", lora_adapters=...) in slots mode
          with the segment kernel, the requests of (a).

    Returns (metrics, launches of qkv_head_transpose per path)."""
    import inspect

    from ultravox_torch.inference.engine import GenerationEngine
    from ultravox_torch.inference.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    L_enc, L_dec, K = cfg.audio_config.num_layers, cfg.text_config.num_layers, 8
    new_tokens, n_rows = 32, ref_batch["input_ids"].shape[0]
    params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16, dev)
    adapters = _adapters(params, torch.bfloat16, torch.Generator(device=dev).manual_seed(SEED + 7),
                         0.05, 0.05, 8)
    rows = [_row(ref_batch, i) for i in range(n_rows)]
    requests, names = rows * 2, [None] * n_rows + ["a", "b"] * (n_rows // 2)
    warm_ids = ref_batch["input_ids"][:2] % (cfg.vocab_size - 1) + 1  # other prompts: no reuse
    warm = [_row(dict(ref_batch, input_ids=warm_ids), i) for i in range(2)]
    fetch = ServingEngine._process_oldest_decode_inner
    lines, first = inspect.getsourcelines(fetch)
    fetch_lines = {(inspect.getsourcefile(fetch), first + i) for i in range(len(lines))}
    per_adm = {"fused_layer_norm": 2 * L_enc, "qkv_head_transpose": L_enc,
               "attention_headmajor": L_enc}
    metrics, qkv_launches = {}, {}

    def reset():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()

    for label, mode, quantize, single_k, block_k in (
        ("lora paged+kernel", "paged", None, "paged_decode_attention", "paged_segment_tail_attention"),
        ("int8+lora slots+kernel", "slots", "int8", "decode_attention", "segment_tail_attention"),
    ):
        srv = ServingEngine(
            params, cfg, num_slots=4, max_seq_len=2048, page_size=256, cache_mode=mode,
            prefill_chunk_tokens=64, decode_block_steps=K, encoder_attn_impl="fused",
            prefill_attn_impl="fused", decode_attn_impl="kernel", block_attn_impl="kernel",
            quantize=quantize, lora_adapters=adapters, device=dev,
        )
        srv.start()
        try:
            _serve(srv, warm, 12, ["a", "b"])
            sites = _sync_sites(lambda: (_serve(srv, warm, 12, ["a", "b"]), time.sleep(0.5)))
            bad = [site for site in sites if site not in fetch_lines]
            print(f"serving {label}: {len(sites)} host waits for the card, "
                  f"{len(sites) - len(bad)} in the fetch, others at {sorted(set(bad))}", flush=True)
            if bad:
                _fail(f"serving {label}: the loop waits for the card outside its fetch at {bad}")
            reset()
            for stat in ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks"):
                setattr(srv, stat, 0)
            srv.stat_fetch_wait_s = srv.stat_dispatch_s = 0.0
            srv.reused_prefix_tokens = 0  # the warm-up reused its own prompts
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = _serve(srv, requests, new_tokens, names)
            wall = time.perf_counter() - t0
            launches = {name: c.launches for name, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 1e9
            disp, steps, chunks = (srv.stat_decode_dispatches, srv.stat_decode_steps,
                                   srv.stat_prefill_chunks)
            dispatch_s, fetch_s = srv.stat_dispatch_s, srv.stat_fetch_wait_s
            reused = srv.reused_prefix_tokens
            _check_pages(srv, label)
            # a second, traced run of other prompts on the same adapters
            other = dict(ref_batch, input_ids=ref_batch["input_ids"][::-1].copy())
            trace = _traced_serve(srv, [_row(other, i) for i in range(n_rows)] * 2, new_tokens,
                                  f"serving {label}", names)
        finally:
            srv.stop()
        del srv
        torch.cuda.empty_cache()
        n_req = len(requests)
        singles, blocks = _check_serving_launches(
            label, launches, counters, {k: v * n_req for k, v in per_adm.items()}, disp, steps,
            chunks, K, L_dec, single_k, block_k)
        qkv_launches[label] = launches["qkv_head_transpose"]
        for i, (ids, finish, _) in enumerate(out):
            if finish != "length" or len(ids) != new_tokens:
                _fail(f"serving {label}: request {i} finished {finish!r} with {len(ids)} tokens")
            if any(not 0 <= t < cfg.vocab_size for t in ids):
                _fail(f"serving {label}: token id out of range")
        toks = [ids for ids, _, _ in out]
        moved = [sum(a != b for a, b in zip(toks[i], toks[n_rows + i])) for i in range(n_rows)]
        base_eq = [sum(a == b for a, b in zip(toks[i], ref_ids[i])) for i in range(n_rows)]
        ttft = sorted(t * 1e3 for _, _, t in out)
        metrics[label] = {
            "ttft_p50_ms": float(np.median(ttft)), "ttft_max_ms": ttft[-1],
            "output_tok_s": n_req * new_tokens / wall, "wall_ms": wall * 1e3,
            "stat_dispatch_s": dispatch_s, "stat_fetch_wait_s": fetch_s, "peak_memory_gb": peak,
            "decode_dispatches": disp, "single_steps": singles, "blocks": blocks,
            "prefill_chunks": chunks, "reused_prefix_tokens": reused,
            "tokens_moved_by_adapter": moved, "base_tokens_equal_to_phase4_generate": base_eq,
            **trace,
        }
        print(f"serving {label}: {n_req} requests x {new_tokens} tokens in {wall * 1e3:.3f} ms "
              f"({n_req * new_tokens / wall:.2f} tok/s); TTFT p50 {np.median(ttft):.3f} ms, max "
              f"{ttft[-1]:.3f} ms; loop dispatch {dispatch_s * 1e3:.3f} ms, fetch wait "
              f"{fetch_s * 1e3:.3f} ms; peak memory {peak:.3f} GB; reused prefix tokens {reused}; "
              f"tokens an adapter changed per row (base vs {names[n_rows:]}) {moved} of "
              f"{new_tokens}; base rows equal to phase 4's generate {base_eq} of {new_tokens}",
              flush=True)
        if reused:
            _fail(f"serving {label}: a prefix was reused across adapters")
        if not any(moved):
            _fail(f"serving {label}: the adapters changed no token")

    # (b) the int8 offline engine on phase 4's batch
    eng = GenerationEngine(params, cfg, max_cache_len=1024, encoder_attn_impl="fused",
                           prefill_attn_impl="fused", decode_attn_impl="kernel", quantize="int8",
                           device=dev)
    del params, adapters
    torch.cuda.empty_cache()
    wbytes = sum(_nbytes(t) for t in _leaves(eng.params))
    eng.generate(ref_batch, max_new_tokens=2)  # warm-up
    reset()
    stamps = []
    t0 = time.perf_counter()
    res = eng.generate(ref_batch, max_new_tokens=new_tokens,
                       token_callback=lambda step, toks, done: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {name: c.launches for name, c in counters.items()}
    steps = new_tokens - 1
    want = {name: 0 for name in counters}
    want.update(per_adm, fused_attention=L_dec, decode_attention=L_dec * steps)
    print(f"launches, int8 generate: {launches} expected {want}", flush=True)
    for name, n in launches.items():
        if n != want[name]:
            _fail(f"int8 generate: {name} launched {n} times, expected {want[name]}")
    qkv_launches["int8 generate"] = launches["qkv_head_transpose"]
    ids = res.token_ids
    if len(ids) != n_rows or any(len(r) != new_tokens for r in ids):
        _fail(f"int8 generate: expected {n_rows} x {new_tokens} tokens, got {[len(r) for r in ids]}")
    same = [sum(a == b for a, b in zip(r, q)) for r, q in zip(ids, ref_ids)]
    ttft_ms = (stamps[0] - t0) * 1e3
    tps = n_rows * steps / (stamps[-1] - stamps[0])
    metrics["int8 generate"] = {
        "ttft_ms": ttft_ms, "decode_tok_s": tps, "total_ms": (t1 - t0) * 1e3,
        "weight_bytes": wbytes, "weight_bytes_bf16": wbytes_bf16,
        "tokens_equal_to_phase4_generate": same,
    }
    print(f"int8 generate: TTFT {ttft_ms:.3f} ms; decode {tps:.2f} tok/s; total "
          f"{(t1 - t0) * 1e3:.3f} ms; weights {wbytes / 1e9:.3f} GB against {wbytes_bf16 / 1e9:.3f} "
          f"GB bf16; tokens equal to phase 4's bf16 generate per row {same} of {new_tokens}; "
          f"first tokens {[r[:8] for r in ids]}", flush=True)
    # what w8a16's per-call bf16 copy of the int8 weight costs: one decode
    # step's product (4 rows) against the same product from a bf16 weight,
    # for layer 0's gate/up and the head
    from ultravox_torch.models.lora import proj_apply

    lm = eng.params["language_model"]
    products = {}
    for name, p in (("gateup_proj", {k: v[0] for k, v in lm["layers"]["gateup_proj"].items()}),
                    ("lm_head", lm["lm_head"])):
        w_bf = (p["kernel_q"].to(torch.bfloat16) * p["scale"]).to(torch.bfloat16)
        K, N = w_bf.shape
        x = torch.randn((n_rows, K), device=dev).to(torch.bfloat16)
        int8_ms, bf16_ms = _time_ms(lambda: proj_apply(x, p)), _time_ms(lambda: x @ w_bf)
        products[name] = {"shape": [K, N], "rows": n_rows, "w8a16_ms": int8_ms,
                          "bf16_ms": bf16_ms, "weight_copy_bytes": K * N * 2}
        print(f"int8 product {name} ({K}, {N}): w8a16 at {n_rows} rows {int8_ms:.4f} ms "
              f"(a bf16 weight: {bf16_ms:.4f} ms; the per-call bf16 copy writes "
              f"{K * N * 2 / 1e6:.1f} MB)", flush=True)
    metrics["int8 generate"]["products"] = products
    del eng, lm
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 7: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, qkv_launches


def _probe_entry_point(eap, dev):
    """Phase 8: ``python -m ultravox_torch.scripts.profile_encoder_attn`` as a
    call: at B 8, T = S = 1500, H 20, D 64 (bf16) it times the production
    encoder attention, every attn_v2 / attn_nt variant of the reference's
    script and SDPA, and holds each variant against its plain version at
    that shape (4 bf16 ulps of the largest output). Fails if a probe's
    counter did not move. Returns (the #15 and #16 rows at block_q 1500 with
    the fp32 exponent, the entry point's result)."""
    from ultravox_torch.scripts import profile_encoder_attn as prof

    t0 = time.perf_counter()
    eap.attn_v2.launches = eap.attn_nt.launches = 0
    result = prof.run(check=True)
    launches = {"attn_v2": eap.attn_v2.launches, "attn_nt": eap.attn_nt.launches}
    print(f"launches, profile_encoder_attn: {launches}", flush=True)
    if not all(launches.values()):
        _fail(f"profile_encoder_attn: a probe kernel was not launched: {launches}")
    by_label = {r["label"]: r for r in result["rows"]}
    q, k, v = prof.make_inputs(dev)
    lens = torch.full((prof.B,), prof.S, dtype=torch.int32, device=dev)
    scale = prof.D**-0.5
    plain_ms = _time_ms(lambda: eap.attn_probe_plain(q, k, v, lens, scale=scale),
                        iters=3, warmup=1)
    library_ms = by_label["library: scaled_dot_product_attention"]["ms"]
    bound_ms, bound_by = _bound(4 * _nbytes(q) + _nbytes(lens), prof.GFLOP * 1e9, BF16_FLOPS)
    rows = []
    for name, label, line in (("attn_v2", "v2 bq=1500 exp=fp32", 75),
                              ("attn_nt", "no-transpose bq=1500 exp=fp32", 140)):
        r = by_label[label]
        fn = getattr(eap, name)
        call = lambda: fn(q, k, v, lens, scale=scale, block_q=1500)  # noqa: E731
        device_ms, per_call, others = _device_ms(call, "attention_mma_kernel", iters=5)
        wrapper_ms = _time_ms(call, iters=5, warmup=1, queued=False)
        rows.append({
            "name": name, "route": "cuda", "source": "ultravox_torch/ops/kernels/csrc/encoder_attn_probe.cu",
            "replaces": f"scripts/profile_encoder_attn.py:{line}", "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "tol": r["tol"], "ms": r["ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": device_ms, "wrapper_ms": wrapper_ms,
            "device_kernels_per_call": per_call, "other_device_work": sorted(set(others)),
            "variant": label, "maxdiff_vs_fused_attention": r["maxdiff"],
            "tflops": r["tflops"], "library_factor": r["ms"] / library_ms,
            "bf16_exponent_ms": by_label[label.replace("fp32", "bf16")]["ms"],
        })
        print(f"kernel {name} ({label}): {r['tflops']:.2f} TF/s, {r['ms'] / library_ms:.2f}x "
              f"SDPA; with the bf16 exponent {rows[-1]['bf16_exponent_ms']:.4f} ms", flush=True)
        print(f"kernel {name} ({label}): ms {r['ms']:.4f} (the kernel alone in the trace "
              f"{device_ms}; other device work {sorted(set(others))}) plain_ms {plain_ms:.4f} "
              f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})", flush=True)
    result["phase_s"] = time.perf_counter() - t0
    print(f"phase 8: {result['phase_s']:.2f} s", flush=True)
    return rows, result


def _flat_paths(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict of tensors (a list's items under
    their index, as the wav2vec2 conv stack)."""
    out = {}
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if isinstance(v, (dict, list)):
            out.update(_flat_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits_differ(want, got) -> list:
    """Paths of the leaves of ``got`` that are not bit-equal to ``want``'s
    (dtype and shape too), and of the leaves either tree lacks."""
    a, b = _flat_paths(want), _flat_paths(got)
    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k].to(a[k].device)
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(k)
        elif x.dtype == torch.bfloat16:
            bad += [k] if not torch.equal(x.view(torch.int16), y.view(torch.int16)) else []
        elif not torch.equal(x, y):
            bad.append(k)
    return bad


def _checkpoint_main_path(tc, uv, cfg, counters, per_call, phase5, dev):
    """Phase 9: a checkpoint of the flagship written, loaded and served with
    every request option, on phase 4's weights (remade from the seed).

      1. save_pretrained writes the bf16 tree in one file, then in two
         shards with an index (each leaf in its own dtype); each is loaded
         onto the card by load_ultravox_checkpoint and must equal phase 4's
         tree bit for bit. Bytes, write and load GB/s (the load reads what
         the write left in the host's page cache).
      2. Phase 3's small llama config: a diff_only checkpoint without bases
         must raise under strict; with text_model_id / audio_model_id
         naming sub-model directories written by decoder_to_hf and
         _encoder_to_hf it must load equal.
      3. The small config's ServingEngine (paged and slots, kernels, fp32):
         greedy tokens with penalties and logit_bias, greedy logprobs
         (within 1e-4, the same top ids) and seeded tokens at temperature
         0.8 on the card equal the CPU's.
      4. A paged ServingEngine with the segment kernel (phase 5 (a)'s
         settings) on the loaded tree serves phase 5's 8 requests on 4
         slots: 2 plain greedy, 2 greedy with repetition 1.2, presence 0.5,
         frequency 0.5 and logit_bias +100 on one id, 2 greedy with
         top_logprobs 5, 2 seeded at temperature 0.8 and top_p 0.9, queued
         before the loop starts (a fixed schedule). An engine on phase 4's
         own tree serves them first: every request's tokens must be equal.
         The biased id comes at every step; greedy logprobs have the chosen
         logprob equal to the top-1's, in descending order; each seeded
         request alone (full prefill) repeats its tokens, another seed
         does not; a request with audio_embeds (encode_audio on the card)
         gives its audio request's tokens. Launches against the engine's
         counters: #1-#3 per admission and #4 per chunk as in phase 5, #9
         16 a single step, #12 16 x 8 a block, and no block dispatched
         while a request that needs single steps is active. TTFT, tok/s and
         (traced) busy share beside phase 5 (a)'s.

    Returns (metrics, launches of #9 and #12 in step 4)."""
    import dataclasses
    import inspect
    import tempfile

    from ultravox_torch.inference.serving.engine import ServingEngine, _needs_single_step
    from ultravox_torch.inference.ultravox_infer import load_ultravox_checkpoint
    from ultravox_torch.models import weights as weights_lib
    from ultravox_torch.ops.mel import log_mel_spectrogram
    from ultravox_torch.tools.publish import _encoder_to_hf, save_pretrained

    t_phase = time.perf_counter()
    metrics = {}

    # 1. the flagship checkpoint, one file and two shards
    params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16, dev)
    loaded = None
    for shards in (1, 2):
        with tempfile.TemporaryDirectory() as d:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_pretrained(params, cfg, d, dtype=None, shards=shards)
            t_write = time.perf_counter() - t0
            files = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
            disk = sum(os.path.getsize(os.path.join(d, f)) for f in files)
            t0 = time.perf_counter()
            lcfg, lparams, _ = load_ultravox_checkpoint(d, torch.bfloat16)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
        bad = _bits_differ(params, lparams)
        label = f"checkpoint, {shards} file{'s' if shards > 1 else ''}"
        print(f"{label}: {disk} bytes in {files}; write {t_write:.3f} s ({disk / t_write / 1e9:.3f} "
              f"GB/s); load onto the card {t_load:.3f} s ({disk / t_load / 1e9:.3f} GB/s); "
              f"{len(_flat_paths(lparams))} leaves, {len(bad)} not bit-equal to phase 4's", flush=True)
        if bad:
            _fail(f"{label}: leaves {bad[:8]} differ from phase 4's")
        if lcfg != cfg:
            _fail(f"{label}: the loaded config {lcfg} differs from the saved one")
        metrics[f"shards_{shards}"] = {"bytes": disk, "files": len(files), "write_s": t_write,
                                       "write_gb_s": disk / t_write / 1e9, "load_s": t_load,
                                       "load_gb_s": disk / t_load / 1e9}
        if loaded is None:
            loaded = lparams
        else:
            del lparams

    # 2. the small config: strict diff checkpoints, bases by id
    (small, small_batch), _ = _small_models(tc)
    sp = _small_params(uv, small)
    with tempfile.TemporaryDirectory() as d:
        diff = save_pretrained(sp, small, os.path.join(d, "diff"), diff_only=True)
        try:
            load_ultravox_checkpoint(diff, torch.float32)
            _fail("a diff_only checkpoint without bases loaded under strict")
        except ValueError as e:
            if "random init" not in str(e):
                raise
        text_dir, audio_dir = os.path.join(d, "text"), os.path.join(d, "audio")
        weights_lib.save_safetensors_dir(
            weights_lib.decoder_to_hf(sp["language_model"], small.text_config), text_dir)
        weights_lib.save_safetensors_dir(_encoder_to_hf(sp["audio_tower"], small), audio_dir)
        ids_cfg = dataclasses.replace(small, text_model_id=text_dir, audio_model_id=audio_dir)
        diff = save_pretrained(sp, ids_cfg, os.path.join(d, "diff_ids"), diff_only=True)
        _, got, _ = load_ultravox_checkpoint(diff, torch.float32)
        bad = _bits_differ(sp, got)
    print(f"checkpoint, small config: a diff without bases raised under strict; with bases by "
          f"id {len(_flat_paths(got))} leaves loaded, {len(bad)} not bit-equal", flush=True)
    if bad:
        _fail(f"small diff checkpoint with bases: leaves {bad[:8]} differ")

    # 3. the small config's options, card against CPU
    small_opts = [
        dict(repetition_penalty=1.2, presence_penalty=0.5, frequency_penalty=0.5,
             logit_bias={7: 5.0}),
        dict(logprobs=True, top_logprobs=5),
        dict(temperature=0.8, top_p=0.9, seed=1234),
    ]
    small_reqs = [_row(small_batch, i % 2) for i in range(len(small_opts))]
    for mode in ("paged", "slots"):
        res = {}
        for device in ("cpu", dev):
            srv = ServingEngine(
                sp, small, num_slots=4, max_seq_len=128, cache_dtype=torch.float32,
                cache_mode=mode, page_size=16, num_pages=20 if mode == "paged" else None,
                prefill_len_buckets=(64, 128), mel_len_buckets=(400,), prefill_chunk_tokens=16,
                decode_block_steps=4, encoder_attn_impl="fused", prefill_attn_impl="fused",
                decode_attn_impl="kernel", block_attn_impl="kernel", device=device)
            evs = []
            try:
                out = _serve(srv, small_reqs, 12, options=small_opts, events=evs)
            finally:
                srv.stop()
            res[device] = ([ids for ids, _, _ in out], evs)
        cpu, gpu = res["cpu"], res[dev]
        lp_err = max(abs(a.logprob - b.logprob) for a, b in zip(cpu[1][1], gpu[1][1]))
        top_err = max(max(abs(x - y) for x, y in zip(a.top_logprobs, b.top_logprobs))
                      for a, b in zip(cpu[1][1], gpu[1][1]))
        same_top = all(a.top_ids == b.top_ids for a, b in zip(cpu[1][1], gpu[1][1]))
        print(f"small serving options {mode}: cpu {cpu[0]} gpu {gpu[0]}; logprobs max |diff| "
              f"{lp_err:.3g} (top-5 {top_err:.3g}), the same top ids {same_top}", flush=True)
        if cpu[0] != gpu[0]:
            _fail(f"small serving options {mode}: the card's tokens differ from the CPU's")
        if lp_err > 1e-4 or top_err > 1e-4 or not same_top:
            _fail(f"small serving options {mode}: logprobs differ from the CPU's")
        metrics[f"small_{mode}_logprob_max_abs_diff"] = max(lp_err, top_err)

    # 4. serve the loaded flagship with every option
    n_req, seconds, prompt_len, new_tokens, K = 8, 10.0, 128, 32, 8
    L_dec = cfg.text_config.num_layers
    rng = np.random.default_rng(SEED + 5)  # phase 5's requests
    mel = log_mel_spectrogram(torch.from_numpy(_audio(n_req, seconds, rng)).to(dev))
    batch = _batch(cfg, mel, prompt_len, rng)
    requests = [_row(batch, i) for i in range(n_req)]
    bias_id = 1000
    kinds = (
        ("plain", {}),
        ("penalized", dict(repetition_penalty=1.2, presence_penalty=0.5, frequency_penalty=0.5,
                           logit_bias={bias_id: 100.0})),
        ("logprobs", dict(top_logprobs=5)),
        ("seeded", dict(temperature=0.8, top_p=0.9)),
    )
    names = [kinds[i % 4][0] for i in range(n_req)]
    options = [dict(kinds[i % 4][1]) for i in range(n_req)]
    for i, name in enumerate(names):
        if name == "seeded":
            options[i]["seed"] = 100 + i
    warm_ids = batch["input_ids"][:4] % (cfg.vocab_size - 1) + 1  # other prompts: no reuse
    warm = [_row(dict(batch, input_ids=warm_ids), i) for i in range(4)]
    fetch = ServingEngine._process_oldest_decode_inner
    lines, first = inspect.getsourcelines(fetch)
    fetch_lines = {(inspect.getsourcefile(fetch), first + i) for i in range(len(lines))}

    def engine(tree):
        return ServingEngine(
            tree, cfg, num_slots=4, max_seq_len=2048, page_size=256, cache_mode="paged",
            prefill_chunk_tokens=64, decode_block_steps=K, encoder_attn_impl="fused",
            prefill_attn_impl="fused", decode_attn_impl="kernel", block_attn_impl="kernel",
            device=dev)

    # the reference: an engine on phase 4's own tree, the same queued requests
    ref_srv = engine(params)
    try:
        _serve(ref_srv, warm, 12, options=options[:4])
        ref_srv.stop()
        ref = [ids for ids, _, _ in _serve(ref_srv, requests, new_tokens, options=options)]
    finally:
        ref_srv.stop()
    del ref_srv, params
    torch.cuda.empty_cache()

    srv = engine(loaded)
    del loaded
    label = "checkpoint serving"
    dispatches = []
    try:
        _serve(srv, warm, 12, options=options[:4])
        # the same prompts again with CUDA sync debugging on: only the
        # loop's fetch may wait for the card
        sites = _sync_sites(lambda: (_serve(srv, warm, 12, options=options[:4]), time.sleep(0.5)))
        bad = [site for site in sites if site not in fetch_lines]
        print(f"{label}: {len(sites)} host waits for the card, {len(sites) - len(bad)} in the "
              f"fetch, others at {sorted(set(bad))}", flush=True)
        if bad:
            _fail(f"{label}: the loop waits for the card outside its fetch at {bad}")
        srv.stop()
        dispatch = srv._dispatch_decode

        def spy(n_steps):
            gated = any(_needs_single_step(r) for r in srv._active.values())
            dispatches.append((n_steps, gated))
            return dispatch(n_steps)

        srv._dispatch_decode = spy
        for c in counters.values():
            c.launches = 0
        for stat in ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks"):
            setattr(srv, stat, 0)
        srv.stat_fetch_wait_s = srv.stat_dispatch_s = 0.0
        torch.cuda.synchronize()
        evs = []
        t0 = time.perf_counter()
        out = _serve(srv, requests, new_tokens, options=options, events=evs)
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        disp, steps, chunks = (srv.stat_decode_dispatches, srv.stat_decode_steps,
                               srv.stat_prefill_chunks)
        del srv._dispatch_decode
        srv.stop()
        _check_pages(srv, label)

        # each seeded request alone, prefilled in full as in the batch
        srv.min_reuse_tokens = 1 << 30
        alone = {i: _serve(srv, [requests[i]], new_tokens, options=[options[i]])[0][0]
                 for i, n in enumerate(names) if n == "seeded"}
        srv.stop()
        i0 = names.index("seeded")
        other_seed = _serve(srv, [requests[i0]], new_tokens,
                            options=[dict(options[i0], seed=options[i0]["seed"] + 1)])[0][0]
        srv.stop()

        # precomputed audio_embeds against the same request with its audio,
        # on prompts not served before, each alone
        fresh = _row(dict(batch, input_ids=(batch["input_ids"] + 7) % (cfg.vocab_size - 1) + 1), 0)
        padded = srv._pad_request(fresh)
        with torch.inference_mode():
            ae = uv.encode_audio(
                srv.params, cfg, torch.from_numpy(padded["audio_values"]).to(dev, torch.bfloat16),
                torch.from_numpy(padded["audio_lens"]).to(dev), encoder_attn_impl="fused")
        with_audio = _serve(srv, [fresh], new_tokens)[0][0]
        srv.stop()
        text_only = {k: v for k, v in fresh.items() if k not in ("audio_values", "audio_lens")}
        with_embeds = _serve(srv, [text_only], new_tokens, options=[dict(audio_embeds=ae)])[0][0]
        srv.stop()

        # a traced run of other prompts with the same options
        trace = _traced_serve(srv, [_row(dict(batch, input_ids=batch["input_ids"][::-1].copy()), i)
                                    for i in range(n_req)], new_tokens, label, options=options)
    finally:
        srv.stop()
    del srv
    torch.cuda.empty_cache()

    # launches against the engine's counters
    singles = sum(1 for n, _ in dispatches if n == 1)
    blocks = sum(1 for n, _ in dispatches if n == K)
    gated_blocks = sum(1 for n, g in dispatches if n > 1 and g)
    want = {name: 0 for name in counters}
    want.update({name: per_call[name] * n_req for name in
                 ("fused_layer_norm", "ln_qkv_head_fused", "attention_headmajor")})
    want.update(fused_attention=L_dec * chunks, paged_decode_attention=L_dec * singles,
                paged_segment_tail_attention=L_dec * K * blocks)
    print(f"{label}: {disp} decode dispatches ({singles} single steps, {blocks} blocks of {K}, "
          f"{gated_blocks} blocks while a request needing single steps was active), {chunks} "
          f"prefill chunks; launches {launches} expected {want}", flush=True)
    if singles + blocks != disp or singles + K * blocks != steps or gated_blocks:
        _fail(f"{label}: dispatches {dispatches} against {disp} dispatches and {steps} steps")
    for name, n in launches.items():
        if n != want[name]:
            _fail(f"{label}: {name} launched {n} times, expected {want[name]}")

    # what came out
    toks = [ids for ids, _, _ in out]
    for i, (ids, finish, _) in enumerate(out):
        if finish != "length" or len(ids) != new_tokens:
            _fail(f"{label}: request {i} ({names[i]}) finished {finish!r} with {len(ids)} tokens")
        if any(not 0 <= t < cfg.vocab_size for t in ids):
            _fail(f"{label}: token id out of range")
    equal = [a == b for a, b in zip(toks, ref)]
    print(f"{label}: tokens equal to the engine on phase 4's tree per request "
          f"{dict(zip(names, equal))}; first tokens {[t[:6] for t in toks]}", flush=True)
    if not all(equal):
        _fail(f"{label}: the loaded tree's tokens differ from phase 4's tree's")
    for i, name in enumerate(names):
        if name == "penalized" and toks[i] != [bias_id] * new_tokens:
            _fail(f"{label}: request {i} should emit the biased id {bias_id} at every step: {toks[i]}")
        if name == "logprobs":
            for ev in evs[i]:
                if (len(ev.top_ids) != 5 or ev.top_ids[0] != ev.token_id
                        or ev.top_logprobs[0] != ev.logprob
                        or list(ev.top_logprobs) != sorted(ev.top_logprobs, reverse=True)):
                    _fail(f"{label}: request {i}'s logprobs are inconsistent: {ev}")
        if name != "logprobs" and any(ev.logprob is not None for ev in evs[i]):
            _fail(f"{label}: request {i} got logprobs it did not ask for")
    for i, ids in alone.items():
        if ids != toks[i]:
            _fail(f"{label}: seeded request {i} alone gave {ids}, in the batch {toks[i]}")
    if other_seed == toks[i0]:
        _fail(f"{label}: another seed gave the same tokens")
    print(f"{label}: seeded requests alone repeat their tokens {sorted(alone)}; another seed "
          f"differs; audio_embeds tokens equal to the audio request's {with_embeds == with_audio} "
          f"({with_embeds[:6]} / {with_audio[:6]})", flush=True)
    if with_embeds != with_audio or len(with_audio) != new_tokens:
        _fail(f"{label}: the request with audio_embeds gave {with_embeds}, with audio {with_audio}")

    ttft = sorted(t * 1e3 for _, _, t in out)
    a5 = phase5["paged+kernel"]
    metrics["serving"] = {
        "ttft_p50_ms": float(np.median(ttft)), "ttft_max_ms": ttft[-1],
        "output_tok_s": n_req * new_tokens / wall, "wall_ms": wall * 1e3,
        "decode_dispatches": disp, "single_steps": singles, "blocks": blocks,
        "prefill_chunks": chunks, "kinds": names, **trace,
    }
    print(f"{label}: {n_req} requests x {new_tokens} tokens in {wall * 1e3:.3f} ms "
          f"({n_req * new_tokens / wall:.2f} tok/s); TTFT p50 {np.median(ttft):.3f} ms, max "
          f"{ttft[-1]:.3f} ms; traced busy {100 * trace['device_busy_share']:.1f}%; phase 5 (a) "
          f"(plain greedy, blocks of {K}): {a5['output_tok_s']:.2f} tok/s, TTFT p50 "
          f"{a5['ttft_p50_ms']:.3f} ms, max {a5['ttft_max_ms']:.3f} ms, busy "
          f"{100 * a5['device_busy_share']:.1f}%", flush=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 9: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, {name: launches[name] for name in
                     ("paged_decode_attention", "paged_segment_tail_attention")}


def _check_serving_launches(label, launches, counters, encoder, disp, steps, chunks, K, L_dec,
                            single_k, block_k, mixed=True):
    """Launches of a serving run against the engine's own counters:

        blocks  = (decode steps - decode dispatches) / (K - 1)
        singles = dispatches - blocks
        single-step kernel = L_dec x singles, block kernel = L_dec x K x
        blocks, gather_pages = blocks (when block_k is None),
        fused_attention = L_dec x prefill chunks, the encoder's kernels as
        given, every other counter 0.

    Fails on a mismatch, on a run without blocks, or (``mixed``) without
    single steps. Returns (singles, blocks)."""
    if (steps - disp) % (K - 1):
        _fail(f"serving {label}: {steps} steps in {disp} dispatches is no mix of 1 and {K}")
    blocks = (steps - disp) // (K - 1)
    singles = disp - blocks
    want = {name: 0 for name in counters}
    want.update(encoder)
    want["fused_attention"] = L_dec * chunks
    want[single_k] = L_dec * singles
    if block_k is not None:
        want[block_k] = L_dec * K * blocks
    else:
        want["gather_pages"] = blocks
    print(f"serving {label}: {disp} decode dispatches ({singles} single steps, {blocks} "
          f"blocks of {K}), {chunks} prefill chunks; launches {launches} expected {want}",
          flush=True)
    for name, n in launches.items():
        if n != want[name]:
            _fail(f"serving {label}: {name} launched {n} times, expected {want[name]}")
    if blocks == 0 or (mixed and singles == 0):
        _fail(f"serving {label}: expected {'both single steps and ' if mixed else ''}blocks")
    return singles, blocks


def _device_events(prof):
    """(kernel and copy events with device time, ms of device time under
    user annotations): torch.optim's ``Optimizer.step#AdamW.step`` range
    shows as a device event spanning the step's kernels and the gaps
    between them, so it is kept out of the busy sum."""
    from torch.autograd import DeviceType

    evs, annotated = [], 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if getattr(e, "is_user_annotation", False):
            annotated += e.self_device_time_total / 1e3
        else:
            evs.append(e)
    return evs, annotated


def _sync_sites(fn):
    """Run fn with CUDA sync debugging on: the (file, line) of every
    Python call that made the host wait for the card, on any thread."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [(w.filename, w.lineno) for w in caught if "synchroniz" in str(w.message)]


def _first_token_ms(engine, batch) -> float:
    """Host ms from the batch to the first greedy token on the host:
    upload, audio embed, prefill, LM head, argmax. Mean of 3."""
    from ultravox_torch.inference.engine import _cache_bucket

    B, T = engine.pad_batch(batch)["input_ids"].shape
    times = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb = {k: torch.as_tensor(v).to(engine.device) for k, v in engine.pad_batch(batch).items()}
            cache = engine._ensure_cache(None, B, _cache_bucket(T + 32, engine.max_cache_len))
            logits, _, _ = engine._prefill(tb, cache, 0)
            logits.argmax(-1).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / len(times)


def _breakdown(engine, batch, new_tokens: int, untraced_ms) -> None:
    """Where the main paths' time goes: host-clock times of the phases, then
    one traced generate, generate_fused and kernel scan: the device's busy
    time (against the untraced wall time of the same call), its kernels by
    self time, #8's and #11's split-kernel time (a one-block kernel in the
    trace fails), and what is left of the plain decode's cache copies
    (direct_copy_kernel) and fp32 gemv (gemmSN_NN)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ultravox_torch.models import ultravox as uv

    tb = {k: torch.as_tensor(v).to(engine.device) for k, v in engine.pad_batch(batch).items()}
    B = tb["input_ids"].shape[0]

    def timed(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    with torch.inference_mode():
        enc_ms = timed(lambda: uv.ultravox_embed(
            engine.params, engine.cfg, tb["input_ids"], tb,
            encoder_attn_impl=engine.encoder_attn_impl))
        cache = engine._ensure_cache(None, B, 256)
        prefill_ms = timed(lambda: engine._prefill(tb, cache, 0))
        logits, cache, lens = engine._prefill(tb, cache, 0)
        tok = logits.argmax(-1).to(torch.int32)
        step_ms = timed(lambda: engine._decode(cache, tok, lens), n=20)
    print(f"phases: audio embed (mel->encoder->projector->splice) {enc_ms:.3f} ms; "
          f"prefill incl. audio embed {prefill_ms:.3f} ms; one decode step (decode kernel) "
          f"{step_ms:.3f} ms", flush=True)

    for label, fn in (
        ("generate", lambda: engine.generate(batch, max_new_tokens=new_tokens)),
        ("generate_fused", lambda: engine.generate_fused(batch, max_new_tokens=new_tokens)),
        ("kernel scan", lambda: _scan_tokens(engine, batch, new_tokens - 1, "kernel")),
    ):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (the CPU ops' rows repeat their kernels' time)
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
        wall = untraced_ms[label]
        print(f"profile {label}: device busy {busy_ms:.3f} ms ({wall:.3f} ms untraced wall: "
              f"{100 * busy_ms / wall:.1f}% busy; {traced_ms:.3f} ms traced)", flush=True)
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}",
                  flush=True)
        _split_kernel_ms(evs, label)
        for name in ("direct_copy_kernel", "gemmSN_NN"):
            mine = [e for e in evs if name in e.key]
            print(f"  {label}: {name} x{sum(e.count for e in mine)}, "
                  f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms", flush=True)


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# phase 10: the voice path (streaming encode, HTTP, the voice WebSocket)
# --------------------------------------------------------------------------

# bf16 streamed embeddings against the batch encode of the same clip: each
# path rounds 12 layers of activations to bf16 in its own order. A relative
# RMS of 2^-5, about twice what the two paths differed by on the CPU at
# d 256 (0.0163).
STREAM_RMS_TOL = 2.0**-5
# fp32 streamed embeddings against the fp32 batch encode: summation order only
STREAM_RMS_TOL_FP32 = 1e-4
VOICE_FRAME = 1365  # the demo page's 4096-sample buffer at 48 kHz, at 16 kHz


# a llama-3-style chat template, written here (nothing is downloaded)
LLAMA3_CHAT_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] not in ['system', 'user', 'assistant'] %}"
    "{{ raise_exception('roles must be system, user or assistant') }}{% endif %}"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{ message['content'] | trim }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}"
)


def _write_flagship_tokenizer(out_dir: str, vocab_size: int = 128256) -> str:
    """A tokenizer over the flagship's whole vocabulary, built here with
    ``tokenizers`` and written as a checkpoint's tokenizer files
    (tokenizer.json, tokenizer_config.json with LLAMA3_CHAT_TEMPLATE): a
    byte-level BPE whose ids 0-255 are the byte alphabet, 256-127999
    unmergeable tokens "t<id>" (so every id a random model emits decodes
    to text) and 128000-128255 llama-3's special tokens. Returns out_dir."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers

    n_special = 256
    alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    vocab.update({f"t{i}": i for i in range(len(vocab), vocab_size - n_special)})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    names = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 6: "<|start_header_id|>",
             7: "<|end_header_id|>", 9: "<|eot_id|>"}
    tok.add_special_tokens([
        AddedToken(names.get(i, f"<|reserved_special_token_{i}|>"), special=True,
                   normalized=False) for i in range(n_special)])
    os.makedirs(out_dir, exist_ok=True)
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                   "chat_template": LLAMA3_CHAT_TEMPLATE, "clean_up_tokenization_spaces": False,
                   "tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return out_dir


class _WsClient:
    """A raw-socket WebSocket client: masked frames out, JSON text frames in."""

    def __init__(self, port: int):
        import base64
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=300)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)  # frames go out at once
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /ws/voice HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
                           ).encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += self.sock.recv(4096)
        head, _, self._buf = resp.partition(b"\r\n\r\n")  # frames may follow the header
        if b" 101 " not in head.split(b"\r\n")[0]:
            _fail(f"phase 10: the WebSocket handshake failed: {head[:200]!r}")

    def send(self, opcode: int, payload: bytes):
        import struct

        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x80 | opcode])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack("!H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack("!Q", n)
        m = np.frombuffer(mask * (n // 4 + 1), np.uint8)[:n]
        self.sock.sendall(head + mask + (np.frombuffer(payload, np.uint8) ^ m).tobytes())

    def _read(self, n: int) -> bytes:
        data, self._buf = self._buf[:n], self._buf[n:]
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                raise ConnectionError("the server closed the WebSocket")
            data += chunk
        return data

    def recv_json(self):
        import struct

        head = self._read(2)
        n = head[1] & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", self._read(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", self._read(8))
        payload = self._read(n)
        return None if head[0] & 0x0F == 8 else json.loads(payload.decode())

    def close(self):
        self.sock.close()


def _post_chat(port: int, body: dict):
    """POST /v1/chat/completions: (text of each choice, seconds to the first
    content chunk for a stream, else None)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        _fail(f"phase 10: HTTP {resp.status}: {resp.read()[:300]!r}")
    if not body.get("stream"):
        out = json.loads(resp.read())
        conn.close()
        return [c["message"]["content"] for c in out["choices"]], None
    text, first, buf = "", None, b""
    while True:
        line = resp.readline()
        if not line:
            break
        buf += line
        if not line.strip() or not line.startswith(b"data: "):
            continue
        data = line[6:].strip()
        if data == b"[DONE]":
            break
        delta = json.loads(data)["choices"][0]["delta"].get("content", "")
        if delta and first is None:
            first = time.perf_counter() - t0
        text += delta
    conn.close()
    return [text], first


def _voice_main_path(tc, uv, cfg, counters, per_call, smi, dev):
    """Phase 10: the voice path at flagship width, on phase 4's weights
    (remade from the seed) with audio_latency_block_size 100 (1 s blocks of
    100 encoder positions, as training/configs/streaming_tinyllama_tpu.yaml
    of the JAX package), served by a paged bf16 ServingEngine (phase 5
    (a)'s settings) behind api_server.make_handler on 127.0.0.1, with the
    flagship tokenizer of _write_flagship_tokenizer read by the port's
    loader.

      1. StreamingAudioEncoder on 10 s of speech in frames of 1365 samples.
         finalize()'s bf16 embeddings against the plain batch block-causal
         encode plus projector of the same clip (mel padded past the
         positions the last token stacks, as the stream pads), in bf16 and
         in fp32 (relative RMS within STREAM_RMS_TOL), and the fp32 stream
         against the fp32 batch (STREAM_RMS_TOL_FP32). The ms of a stream
         step (p50 over the blocks, the frame's mel included), of finalize
         and of the engine's batch encode (the fused path) of the clip.
      2. HTTP: 4 requests of a 10 s WAV at 16 kHz and one at 24 kHz (the
         resample path), greedy, max_tokens 32, sent at once, plain and
         then streamed: TTFT p50 (the engine's, submit to first token),
         output tok/s, and launches against the engine's counters (#1-#3
         with the latency block 12 each per admission, #4 16 a prefill
         chunk, #9 16 a single step, #12 16 x 8 a block). Then each request
         alone, plain and streamed, against submit on the same batch
         (decoded by the same tokenizer): the texts must be equal. Alone,
         because greedy bf16 tokens depend on whether a step ran in a block
         or alone, which concurrency decides; the prefix reuse is off so
         every prefill starts at 0.
      3. The voice WebSocket: 6 s of speech and 1 s of silence in PCM16
         frames of 1365 samples, paced at real time, two turns. Each turn
         must reach the engine as audio_embeds, with no launch of #1-#3
         while it runs. Pause-to-first-token (from sending the frame that
         completes the pause, found by running the same VAD here, to the
         first token frame) beside the TTFT of the same utterance sent as
         raw audio (processor to first token: the batch path). Then the
         decode step time of 4 text requests with and without stream steps
         running back to back on another thread.

    Returns (metrics, launches of #1/#2/#3/#9/#12 in step 2's plain round)."""
    import base64
    import dataclasses
    import tempfile
    import threading
    from http.server import ThreadingHTTPServer

    from ultravox_torch.data.sample import audio_to_wav_bytes
    from ultravox_torch.inference.serving import api_server
    from ultravox_torch.models.tokenizer import load_tokenizer
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.inference.streaming import StreamingAudioEncoder
    from ultravox_torch.models.processor import DataCollatorWithAudio, UltravoxProcessor
    from ultravox_torch.ops.mel import log_mel_spectrogram_np
    from ultravox_torch.utils.audio import resample
    from ultravox_torch.utils.vad import ReplyOnPause

    t_phase = time.perf_counter()
    metrics = {}
    scfg = dataclasses.replace(cfg, audio_latency_block_size=100)
    L_enc, L_dec, K, new_tokens = scfg.audio_config.num_layers, scfg.text_config.num_layers, 8, 32
    params = uv.init_params(scfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16, dev)
    engine = ServingEngine(
        params, scfg, num_slots=4, max_seq_len=2048, page_size=256, cache_mode="paged",
        prefill_chunk_tokens=64, decode_block_steps=K, encoder_attn_impl="fused",
        prefill_attn_impl="fused", decode_attn_impl="kernel", block_attn_impl="kernel", device=dev)
    del params
    rng = np.random.default_rng(SEED + 10)
    clips = _audio(6, 10.0, rng)  # 10 s each at 16 kHz

    # 1. streaming encode on the card
    def stream(tree, clip, dtype, times=None):
        enc = StreamingAudioEncoder(tree, scfg, dtype=dtype)
        for i in range(0, len(clip), VOICE_FRAME):
            before = enc.blocks_encoded
            t0 = time.perf_counter()
            enc.feed(clip[i: i + VOICE_FRAME])
            torch.cuda.synchronize()
            if times is not None and enc.blocks_encoded > before:
                times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        out = enc.finalize()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, enc.blocks_encoded

    clip = clips[0]
    stream(engine.params, clip, torch.bfloat16)  # warm-up
    step_ms = []
    emb16, final_ms, blocks = stream(engine.params, clip, torch.bfloat16, step_ms)
    tree32 = {k: _to_float(engine.params[k]) for k in ("audio_tower", "projector")}
    emb32, _, _ = stream(tree32, clip, torch.float32)
    mel = log_mel_spectrogram_np(clip)  # (80, 1000)
    n_tok = emb16.shape[0]
    padded = np.zeros((1, 80, 2 * n_tok * scfg.stack_factor), np.float32)  # 1008 frames
    padded[0, :, : mel.shape[1]] = mel
    lens = torch.tensor([mel.shape[1]], device=dev)
    with torch.inference_mode():
        ref32 = uv.encode_audio(tree32, scfg, torch.from_numpy(padded).to(dev), lens)[0, :n_tok]
        ref16 = uv.encode_audio(engine.params, scfg, torch.from_numpy(padded).to(dev, torch.bfloat16),
                                lens)[0, :n_tok]
        mel16 = torch.from_numpy(mel[None]).to(dev, torch.bfloat16)
        fused = lambda: uv.encode_audio(engine.params, scfg, mel16, lens,  # noqa: E731
                                        encoder_attn_impl="fused")
        fused16 = fused()[0, :n_tok]
        fused()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fused()
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) / 5 * 1e3
    errs = {"bf16 stream vs bf16 batch": _rel_rms(emb16, ref16),
            "bf16 stream vs fp32 batch": _rel_rms(emb16, ref32),
            "fp32 stream vs fp32 batch": _rel_rms(emb32, ref32),
            "fused bf16 batch (the engine's, tanh GELU) vs fp32 batch": _rel_rms(fused16[:-1],
                                                                                  ref32[:-1])}
    print(f"voice stream: 10 s in frames of {VOICE_FRAME}: {blocks} blocks of 100 positions, "
          f"{n_tok} tokens; relative RMS {errs} (tolerance {STREAM_RMS_TOL}, fp32 "
          f"{STREAM_RMS_TOL_FP32}); stream step p50 {np.median(step_ms):.3f} ms (of "
          f"{len(step_ms)} steps during the feed), finalize {final_ms:.3f} ms, batch encode "
          f"(fused) {batch_ms:.3f} ms; {smi}", flush=True)
    if emb16.shape != (63, scfg.text_config.hidden_size) or not torch.isfinite(emb16).all():
        _fail(f"phase 10: streamed embeddings {tuple(emb16.shape)} or not finite")
    if (errs["fp32 stream vs fp32 batch"] > STREAM_RMS_TOL_FP32
            or errs["bf16 stream vs bf16 batch"] > STREAM_RMS_TOL
            or errs["bf16 stream vs fp32 batch"] > STREAM_RMS_TOL):
        _fail(f"phase 10: the streamed embeddings differ from the batch encode: {errs}")
    metrics["stream"] = {"step_ms_p50": float(np.median(step_ms)), "step_ms": step_ms,
                         "finalize_ms": final_ms, "batch_encode_ms": batch_ms, "blocks": blocks,
                         "rel_rms": errs}
    del tree32, emb32, ref32

    # 2. HTTP
    with tempfile.TemporaryDirectory() as tok_dir:
        tok = load_tokenizer(_write_flagship_tokenizer(tok_dir))
    tok.pad_token = tok.eos_token
    processor = UltravoxProcessor(tok, num_mel_bins=80, stack_factor=scfg.stack_factor)
    collator = DataCollatorWithAudio(pad_token_id=tok.pad_token_id, mel_pad_multiple=500)
    api = api_server.ServingAPI(engine, processor, collator)
    api.handle_voice_ws = functools.partial(api_server.ServingAPI.handle_voice_ws, api,
                                            max_tokens=new_tokens)
    submitted = []
    submit = engine.submit

    def spy(batch, **kw):
        req = submit(batch, **kw)
        submitted.append((kw.get("audio_embeds") is not None, batch.get("audio_values"), req))
        return req

    engine.submit = spy
    engine.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), api_server.make_handler(api))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        wav24 = resample(clips[4], 16000, 24000)
        wavs = [(clips[i], 16000) for i in range(4)] + [(wav24, 24000)]
        bodies = [{"model": "ultravox-torch", "max_tokens": new_tokens, "temperature": 0,
                   "messages": [{"role": "user", "content": [
                       {"type": "text", "text": "Transcribe: "},
                       {"type": "input_audio", "input_audio": {
                           "data": base64.b64encode(audio_to_wav_bytes(a, sr)).decode(),
                           "format": "wav"}}]}]} for a, sr in wavs]
        _post_chat(port, dict(bodies[0], max_tokens=4))  # warm-up

        def round_(stream_):
            out = [None] * len(bodies)

            def one(i):
                out[i] = _post_chat(port, dict(bodies[i], stream=stream_))

            del submitted[:]
            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return out, time.perf_counter() - t0

        http = {}
        for stream_ in (False, True):
            label = "stream" if stream_ else "plain"
            for c in counters.values():
                c.launches = 0
            for stat in ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks"):
                setattr(engine, stat, 0)
            out, wall = round_(stream_)
            torch.cuda.synchronize()
            launches = {name: c.launches for name, c in counters.items()}
            reqs = [r for _, _, r in submitted]
            if any(o is None for o in out) or len(reqs) != len(bodies):
                _fail(f"phase 10: HTTP {label}: {len(reqs)} requests reached the engine")
            n_gen = sum(r.generated for r in reqs)
            ttft = sorted((r.first_token_time - r.submit_time) * 1e3 for r in reqs)
            http[label] = {"ttft_p50_ms": float(np.median(ttft)), "ttft_max_ms": ttft[-1],
                           "output_tok_s": n_gen / wall, "wall_ms": wall * 1e3,
                           "client_first_chunk_ms": [o[1] * 1e3 for o in out] if stream_ else None}
            print(f"voice http {label}: {len(bodies)} requests x {new_tokens} tokens (4 at 16 kHz, "
                  f"1 at 24 kHz) in {wall * 1e3:.3f} ms ({n_gen / wall:.2f} tok/s); TTFT p50 "
                  f"{np.median(ttft):.3f} ms, max {ttft[-1]:.3f} ms; {smi}", flush=True)
            if not stream_:
                encoder = {name: per_call[name] * len(bodies) for name in
                           ("fused_layer_norm", "ln_qkv_head_fused", "attention_headmajor")}
                _check_serving_launches(
                    "voice http", launches, counters, encoder, engine.stat_decode_dispatches,
                    engine.stat_decode_steps, engine.stat_prefill_chunks, K, L_dec,
                    "paged_decode_attention", "paged_segment_tail_attention")
                http_launches = {k: launches[k] for k in (
                    "fused_layer_norm", "ln_qkv_head_fused", "attention_headmajor",
                    "paged_decode_attention", "paged_segment_tail_attention")}
                if any(r.batch["audio_values"].shape[-1] != 1000 for r in reqs):
                    _fail("phase 10: an HTTP request's mel is not 1000 frames")

        # each request alone: HTTP plain and streamed against a direct submit
        reuse, engine.min_reuse_tokens = engine.min_reuse_tokens, 1 << 30
        equal = []
        for body in bodies:
            plain = _post_chat(port, body)[0][0]
            streamed = _post_chat(port, dict(body, stream=True))[0][0]
            messages, audios = api.parse_messages(body["messages"])
            text = tok.apply_chat_template(messages, tokenize=False, add_generation_prompt=True)
            batch = collator([processor(text=text, audios=audios)])
            req = engine.submit(batch, max_tokens=new_tokens, stop_token_ids=(tok.eos_token_id,))
            ids = [ev.token_id for ev in engine.stream(req, timeout=600) if ev.token_id is not None]
            direct = tok.decode(ids, skip_special_tokens=True)
            equal.append(plain == streamed == direct)
            if not equal[-1] or len(ids) != new_tokens:
                _fail(f"phase 10: HTTP alone gave {plain[:80]!r} / streamed {streamed[:80]!r}, "
                      f"submit {direct[:80]!r} ({len(ids)} tokens)")
        print(f"voice http: each request alone, plain and streamed, equal to submit on the same "
              f"batch: {equal}; first text {plain[:60]!r}", flush=True)
        metrics["http"] = http

        # 3. the voice WebSocket (prefix reuse back on: turn 2 adopts turn 1)
        engine.min_reuse_tokens = reuse
        vad_frames = []
        turns = []
        vad = ReplyOnPause()  # the server's VAD sees both turns in order
        for clip in (clips[1][:96000], clips[2][:96000]):
            pcm = (np.clip(np.concatenate([clip, np.zeros(16000, np.float32)]), -1, 1)
                   * 32767).astype(np.int16)
            frames = [pcm[i: i + VOICE_FRAME] for i in range(0, len(pcm), VOICE_FRAME)]
            fired = [j for j, f in enumerate(frames)
                     if vad.process(f.astype(np.float32) / 32768.0) is not None]
            if len(fired) != 1:
                _fail(f"phase 10: the VAD fired at frames {fired}, expected once")
            vad_frames.append(fired[0])
            turns.append(frames)
        utterances = []
        client = _WsClient(port)
        ws = []
        try:
            if client.recv_json() != {"type": "ready"}:
                _fail("phase 10: the WebSocket did not say ready")
            for frames, pause_at in zip(turns, vad_frames):
                for c in counters.values():
                    c.launches = 0
                del submitted[:]
                sent = [None] * len(frames)

                def send(frames=frames, sent=sent):
                    t0 = time.monotonic()  # the engine's clock (submit and token times)
                    for j, f in enumerate(frames):
                        wait = t0 + j * VOICE_FRAME / 16000 - time.monotonic()
                        if wait > 0:
                            time.sleep(wait)
                        sent[j] = time.monotonic()
                        client.send(0x2, f.tobytes())

                sender = threading.Thread(target=send)
                sender.start()
                events, first = [], None
                while True:
                    ev = client.recv_json()
                    if ev is None:
                        _fail("phase 10: the WebSocket closed mid-turn")
                    if ev["type"] == "token" and first is None:
                        first = time.monotonic()
                    events.append(ev)
                    if ev["type"] == "turn_end":
                        break
                sender.join()
                torch.cuda.synchronize()
                launches = {name: c.launches for name, c in counters.items()}
                kinds = [e["type"] for e in events]
                if kinds[0] != "utterance" or "token" not in kinds or first is None:
                    _fail(f"phase 10: WebSocket events {kinds[:8]}")
                if len(submitted) != 1 or not submitted[0][0]:
                    _fail("phase 10: a voice turn did not reach the engine as audio_embeds")
                enc = {k: launches[k] for k in ("fused_layer_norm", "ln_qkv_head_fused",
                                                "attention_headmajor", "qkv_head_transpose")}
                if any(enc.values()):
                    _fail(f"phase 10: a streaming turn launched encoder kernels {enc}")
                req = submitted[0][2]
                ptft = (first - sent[pause_at]) * 1e3
                # where it went: the handler up to submit (VAD, the stream's
                # tail and projector, processor, copy to the host), the
                # engine to its first token, then the frame to the client
                split = {"handler_ms": (req.submit_time - sent[pause_at]) * 1e3,
                         "engine_ttft_ms": (req.first_token_time - req.submit_time) * 1e3,
                         "delivery_ms": (first - req.first_token_time) * 1e3}
                ws.append({"pause_to_first_token_ms": ptft, "utterance_s": events[0]["seconds"],
                           **split,
                           "audio_chunks": int(req.audio_embeds.shape[0]),
                           "reply_tokens": req.generated, "launches": launches})
                utterances.append(events[0]["seconds"])
                print(f"voice ws turn {len(ws)}: utterance {events[0]['seconds']:.3f} s, "
                      f"{req.audio_embeds.shape[0]} audio chunk(s) as audio_embeds; "
                      f"pause-to-first-token {ptft:.3f} ms: handler to submit "
                      f"{split['handler_ms']:.3f}, engine TTFT {split['engine_ttft_ms']:.3f}, "
                      f"delivery {split['delivery_ms']:.3f}; encoder kernels {enc}; #4 "
                      f"{launches['fused_attention']}, #9 {launches['paged_decode_attention']}, "
                      f"#12 {launches['paged_segment_tail_attention']}; reply "
                      f"{events[-1]['text'][:40]!r}; {smi}", flush=True)
        finally:
            client.close()

        # the first turn's utterance as raw audio: the batch path's TTFT
        vad = ReplyOnPause()
        utt = None
        for f in turns[0]:
            utt = vad.process(f.astype(np.float32) / 32768.0) if utt is None else utt
        msgs = [{"role": "user", "content": "<|audio|>"}]
        batch_ttft, batch_engine = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            text = tok.apply_chat_template(msgs, tokenize=False, add_generation_prompt=True)
            req = engine.submit(collator([processor(text=text, audios=[utt])]), max_tokens=2,
                                stop_token_ids=(tok.eos_token_id,))
            for ev in engine.stream(req, timeout=600):
                batch_ttft.append((time.perf_counter() - t0) * 1e3)
                break
            for _ in engine.stream(req, timeout=600):
                pass
            batch_engine.append((req.first_token_time - req.submit_time) * 1e3)
        print(f"voice ws: pause-to-first-token {[round(w['pause_to_first_token_ms'], 3) for w in ws]} "
              f"ms beside the same first utterance ({len(utt) / 16000:.3f} s) as raw audio, "
              f"processor to first token {[round(t, 3) for t in batch_ttft]} ms (engine TTFT "
              f"{[round(t, 3) for t in batch_engine]}); {smi}", flush=True)
        metrics["ws"] = {"turns": ws, "batch_path_ttft_ms": batch_ttft,
                         "batch_path_engine_ttft_ms": batch_engine}

        # decode steps with and without stream steps on another thread
        ids = rng.integers(300, scfg.vocab_size, (4, 128)).astype(np.int64)
        text_reqs = [{"input_ids": ids[i: i + 1], "attention_mask": np.ones((1, 128), np.int64)}
                     for i in range(4)]

        def decode_step_ms(concurrent: bool):
            stop, steps = threading.Event(), [0]

            def streamer():
                while not stop.is_set():
                    enc = StreamingAudioEncoder(engine.params, scfg, dtype=torch.bfloat16)
                    for i in range(0, len(clips[5]), VOICE_FRAME):
                        if stop.is_set():
                            break
                        before = enc.blocks_encoded
                        enc.feed(clips[5][i: i + VOICE_FRAME])
                        steps[0] += enc.blocks_encoded - before

            th = threading.Thread(target=streamer)
            if concurrent:
                th.start()
            reqs = [engine.submit(dict(b), max_tokens=64) for b in text_reqs]
            for r in reqs:
                for _ in engine.stream(r, timeout=600):
                    pass
            stop.set()
            if concurrent:
                th.join()
            per = [(r.finish_time - r.first_token_time) / (r.generated - 1) * 1e3 for r in reqs]
            return float(np.median(per)), steps[0]

        decode_step_ms(False)  # warm-up
        alone, _ = decode_step_ms(False)
        with_stream, n_steps = decode_step_ms(True)
        alone2, _ = decode_step_ms(False)
        print(f"voice: decode step (4 text requests x 64 tokens, blocks of {K}) {alone:.3f} / "
              f"{alone2:.3f} ms alone, {with_stream:.3f} ms with {n_steps} stream steps run back "
              f"to back on another thread ({with_stream / alone:.3f}x); {smi}", flush=True)
        metrics["decode_step_ms"] = {"alone": [alone, alone2], "with_stream_steps": with_stream,
                                     "stream_steps": n_steps}
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    _check_pages(engine, "voice")
    del engine, api
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 10: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, http_launches


# --------------------------------------------------------------------------
# phase 11: the offline front doors, main() and speculative decoding
# --------------------------------------------------------------------------

# Speculative greedy tokens against the same engine without speculation:
# in exact arithmetic the two are equal; in bf16 a verify forward at T = 9
# rounds otherwise than a single step, so the two may part where the top
# two logits are close. The rule, at every generated position of every run
# (with and without speculation): one teacher-forced bf16 forward of the
# run's own tokens gives the logits there, and the emitted token must be
# their argmax or lie less than SPEC_MARGIN below it. 0.09375 is 6 bf16
# ulps at logits in [2, 4): above the largest top-2 margin at a first
# difference seen on the card (0.0625) and below the median top-2 margin
# of this traffic (0.1641), so a token picked at random would fail.
SPEC_MARGIN = 0.09375


def _stream_equal(streamed: str, full: str) -> bool:
    """Streamed text against the whole decode: equal, but for a trailing
    U+FFFD (bytes not valid UTF-8) that a stream holds back and never
    sends."""
    return streamed == full or (full.endswith("\ufffd") and full.startswith(streamed))


def _wait_idle(engine, timeout: float = 60.0) -> None:
    """Until the loop has nothing active, queued or in flight: a request's
    last event can come before the loop has processed the lagged
    dispatches behind it, which still feed the speculation guard."""
    t_end = time.perf_counter() + timeout
    while (engine._active or engine._inflight or engine._prefilling
           or not engine._pending.empty() or not engine._cancels.empty()):
        if time.perf_counter() > t_end:
            _fail("the serving loop did not go idle")
        time.sleep(0.005)
    time.sleep(0.05)  # the tick that saw the last entry go


def _reset_spec_guard(engine) -> None:
    """The engine's speculation guard back to its cold start, once the loop
    is idle."""
    _wait_idle(engine)
    engine._reset_spec_guard()


def _spec_stats(engine) -> dict:
    return {k: getattr(engine, k) for k in (
        "spec_dispatches", "spec_single_dispatches", "spec_probe_dispatches", "spec_syncs",
        "spec_autopauses", "spec_rows", "spec_accepted_sum", "spec_emitted_tokens",
        "spec_wasted_tokens")}


def _teacher_forced(params, cfg, batch, tokens, prompt_len: int, dev):
    """(top-1 minus top-2 logit, argmax, top-1 minus the emitted token's
    logit) at each generated position of ``tokens`` (n rows of
    new_tokens), from one bf16 forward of prompt + tokens[:-1] without a
    cache (the plain attention)."""
    from ultravox_torch.models import decoder as decoder_lib

    toks = np.asarray(tokens, np.int64)
    ids = np.concatenate([batch["input_ids"], toks[:, :-1]], axis=1)
    b = {k: torch.as_tensor(v).to(dev) for k, v in dict(
        batch, input_ids=ids, attention_mask=np.ones_like(ids)).items()}
    n, T = ids.shape
    lm, tc = params["language_model"], cfg.text_config
    with torch.inference_mode():
        from ultravox_torch.models import ultravox as uv

        emb = uv.ultravox_embed(params, cfg, b["input_ids"], b, encoder_attn_impl="fused")
        hidden, _ = decoder_lib.decoder_forward(
            lm, tc, inputs_embeds=emb, positions=torch.arange(T, device=dev)[None].expand(n, T),
            kv_valid_len=torch.full((n,), T, dtype=torch.int32, device=dev), return_hidden=True)
        logits = decoder_lib.compute_logits(lm, tc, hidden[:, prompt_len - 1:]).float()
        top2 = logits.topk(2, dim=-1).values
        emitted = logits.gather(-1, torch.as_tensor(toks, device=dev)[..., None])[..., 0]
        return ((top2[..., 0] - top2[..., 1]).cpu().numpy(), logits.argmax(-1).cpu().numpy(),
                (top2[..., 0] - emitted).cpu().numpy())


def _check_greedy_tokens(label, params, cfg, batch, tokens, prompt_len, dev):
    """SPEC_MARGIN's rule at every position of one run; returns (positions
    off the teacher's argmax, their largest gap, the top-2 margins)."""
    margins, argmax, gaps = _teacher_forced(params, cfg, batch, tokens, prompt_len, dev)
    off = argmax != np.asarray(tokens)
    worst = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
    if not gaps[worst] < SPEC_MARGIN:
        _fail(f"{label}: request {worst[0]} emitted at position {worst[1]} a token "
              f"{gaps[worst]:.4f} below the teacher-forced top logit (the bound is {SPEC_MARGIN})")
    return int(off.sum()), float(gaps.max()), margins


def _first_differences(spec_tokens, base_tokens, margins):
    """(requests fully equal, first differences from the run without
    speculation, each with its top-2 margin there)."""
    equal, parts = 0, []
    for i, (a, b) in enumerate(zip(spec_tokens, base_tokens)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            equal += len(a) == len(b)
        else:
            parts.append((i, j, float(margins[i][j])))
    return equal, parts


def _spec_serving(params, cfg, counters, per_call, smi, dev):
    """Phase 11 (d): phase 5's traffic (8 greedy requests, 10 s of audio in
    a 128-token prompt, 32 tokens, 4 slots, chunks of 64, blocks of 8, the
    segment kernels in blocks) on two engines, slots + kernel and paged +
    kernel, each run three ways in turn: without speculation, with
    spec_decode="ngram" (K 8) and the health guard off (spec_min_accept 0,
    so multi-round speculative blocks run: #11 / #12 at T = 9), and with the
    default guard (cold-start probe of single rounds, then multi-round or a
    pause). Each run: launches against the engine's counters,

        blocks = (decode steps - decode dispatches) / 7,
        singles = decode dispatches - blocks,
        single-round spec = spec_single_dispatches + spec_probe_dispatches,
        multi-round rounds = spec_dispatches - single-round spec,
        #8 / #9 = 16 x singles, #11 / #12 = 16 x (8 x blocks + multi-round
        rounds), #4 = 16 x prefill chunks, #1-#3 per admission,

    (a single-round verify is decoder_forward at T = 9 against the cache:
    the plain attention, no kernel), tok/s, TTFT p50, accepted tokens a
    round a slot, spec dispatches and autopauses; the speculative tokens
    and every run's tokens under SPEC_MARGIN's rule at every position, with
    the requests equal to the run without speculation counted.

    Returns (metrics, #11 and #12 launches at T = 9 in the guard-off runs)."""
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.ops.mel import log_mel_spectrogram

    n_req, seconds, prompt_len, new_tokens, K = 8, 10.0, 128, 32, 8
    L_dec = cfg.text_config.num_layers
    rng = np.random.default_rng(SEED + 5)  # phase 5's requests
    mel = log_mel_spectrogram(torch.from_numpy(_audio(n_req, seconds, rng)).to(dev))
    batch = _batch(cfg, mel, prompt_len, rng)
    warm_ids = batch["input_ids"][:2] % (cfg.vocab_size - 1) + 1  # other prompts: no reuse
    warm = [_row(dict(batch, input_ids=warm_ids), i) for i in range(2)]
    requests = [_row(batch, i) for i in range(n_req)]
    encoder = {name: per_call[name] * n_req for name in
               ("fused_layer_norm", "ln_qkv_head_fused", "attention_headmajor")}
    metrics, t9 = {}, {}
    for label, mode, single_k, block_k in (
            ("slots+kernel", "slots", "decode_attention", "segment_tail_attention"),
            ("paged+kernel", "paged", "paged_decode_attention", "paged_segment_tail_attention")):
        runs = {}
        for variant, spec_kw in (("no spec", {}),
                                 ("spec", dict(spec_decode="ngram", spec_k=K, spec_min_accept=0)),
                                 ("spec+guard", dict(spec_decode="ngram", spec_k=K))):
            srv = ServingEngine(
                params, cfg, num_slots=4, max_seq_len=2048, page_size=256, cache_mode=mode,
                prefill_chunk_tokens=64, decode_block_steps=K, encoder_attn_impl="fused",
                prefill_attn_impl="fused", decode_attn_impl="kernel", block_attn_impl="kernel",
                device=dev, **spec_kw)
            try:
                _serve(srv, warm, 12)
                _wait_idle(srv)
                if srv.spec_decode:
                    srv._reset_spec_guard()
                st0 = _spec_stats(srv)
                for c in counters.values():
                    c.launches = 0
                for stat in ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks"):
                    setattr(srv, stat, 0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _serve(srv, requests, new_tokens)
                wall = time.perf_counter() - t0
                launches = {name: c.launches for name, c in counters.items()}
                _check_pages(srv, f"spec serving {label} {variant}")
            finally:
                srv.stop()
            disp, steps, chunks = (srv.stat_decode_dispatches, srv.stat_decode_steps,
                                   srv.stat_prefill_chunks)
            st = {k: v - st0[k] for k, v in _spec_stats(srv).items()}
            del srv
            torch.cuda.empty_cache()
            name = f"spec serving {label}, {variant}"
            if (steps - disp) % (K - 1):
                _fail(f"{name}: {steps} steps in {disp} dispatches is no mix of 1 and {K}")
            blocks = (steps - disp) // (K - 1)
            singles = disp - blocks
            single_rounds = st["spec_single_dispatches"] + st["spec_probe_dispatches"]
            multi = st["spec_dispatches"] - single_rounds
            want = {n: 0 for n in counters}
            want.update(encoder)
            want["fused_attention"] = L_dec * chunks
            want[single_k] = L_dec * singles
            want[block_k] = L_dec * (K * blocks + multi)
            print(f"{name}: {disp} decode dispatches ({singles} single steps, {blocks} blocks of "
                  f"{K}), {st['spec_dispatches']} speculative rounds ({single_rounds} single-round "
                  f"dispatches, {multi} rounds in multi-round blocks), {chunks} prefill chunks; "
                  f"launches {launches} expected {want}", flush=True)
            for n, c in launches.items():
                if c != want[n]:
                    _fail(f"{name}: {n} launched {c} times, expected {want[n]}")
            if variant == "spec" and multi == 0:
                _fail(f"{name}: no multi-round speculative block ran")
            for i, (ids, finish, _) in enumerate(out):
                if finish != "length" or len(ids) != new_tokens:
                    _fail(f"{name}: request {i} finished {finish!r} with {len(ids)} tokens")
                if any(not 0 <= t < cfg.vocab_size for t in ids):
                    _fail(f"{name}: token id out of range")
            ttft = sorted(t * 1e3 for _, _, t in out)
            acc = st["spec_accepted_sum"] / st["spec_rows"] if st["spec_rows"] else None
            runs[variant] = {
                "tokens": [ids for ids, _, _ in out], "output_tok_s": n_req * new_tokens / wall,
                "wall_ms": wall * 1e3, "ttft_p50_ms": float(np.median(ttft)),
                "ttft_max_ms": ttft[-1], "decode_dispatches": disp, "single_steps": singles,
                "blocks": blocks, "prefill_chunks": chunks, "multi_round_rounds": multi,
                "t9_launches": L_dec * multi, "accepted_per_round_per_slot": acc, **st,
            }
            print(f"{name}: {n_req} requests x {new_tokens} tokens in {wall * 1e3:.3f} ms "
                  f"({n_req * new_tokens / wall:.2f} tok/s); TTFT p50 {np.median(ttft):.3f} ms, max "
                  f"{ttft[-1]:.3f} ms; accepted tokens a round a slot {acc}; speculative rounds "
                  f"{st['spec_dispatches']}, autopauses {st['spec_autopauses']}; {block_k} at T = 9 "
                  f"{L_dec * multi} launches; {smi}", flush=True)
        base = runs["no spec"]["tokens"]
        for variant, run in runs.items():
            off, worst, margins = _check_greedy_tokens(
                f"spec serving {label}, {variant}", params, cfg, batch, run["tokens"], prompt_len,
                dev)
            run["off_argmax"], run["largest_gap"] = off, worst
            print(f"spec serving {label}, {variant}: {n_req * new_tokens - off} of "
                  f"{n_req * new_tokens} tokens are the teacher-forced argmax, the largest gap "
                  f"below it {worst:.6f} (bound {SPEC_MARGIN}); top-2 margin p10/p50 "
                  f"{np.percentile(margins, 10):.4f} / {np.median(margins):.4f}", flush=True)
            if variant == "no spec":
                base_margins = margins
        for variant in ("spec", "spec+guard"):
            equal, parts = _first_differences(runs[variant]["tokens"], base, base_margins)
            runs[variant]["requests_equal"] = equal
            runs[variant]["first_differences"] = parts
            print(f"spec serving {label}, {variant}: {equal} of {n_req} requests equal to the run "
                  f"without speculation; first differences (request, position, top-2 margin) "
                  f"{parts}; tok/s {runs[variant]['output_tok_s']:.2f} "
                  f"against {runs['no spec']['output_tok_s']:.2f}, TTFT p50 "
                  f"{runs[variant]['ttft_p50_ms']:.3f} against {runs['no spec']['ttft_p50_ms']:.3f} "
                  f"ms", flush=True)
        for r_ in runs.values():
            del r_["tokens"]
        metrics[label] = runs
        t9[block_k] = runs["spec"]["t9_launches"]
    return metrics, t9


def _front_doors_main_path(tc, uv, cfg, counters, per_call, gen_launches, smi, dev):
    """Phase 11: the front doors and speculative decoding at flagship width
    on phase 4's weights (remade from the seed).

      (a) A checkpoint directory: save_pretrained of the bf16 tree and the
          tokenizer of _write_flagship_tokenizer (128256 ids, a llama-3-style
          chat template written inline).
      (b) UltravoxInference(dir) on the card (the fused encoder, the fused
          prefill, the decode kernel): infer on 10 s of audio, its launches
          of #1-#4 and #8 checked against phase 4's generate (12/12/12/16,
          16 a decode step); infer_stream, chunks printed and joined equal
          to infer's text, stats and TTFT; two conversation turns, the
          second prefilling only its suffix (printed); one
          ultravox_torch.pipeline(dir) call on int16 audio.
      (c) The command-line server: api_server.build_api with --spec-decode
          ngram --spec-k 8 at 8192 positions (auto: paged, every kernel,
          bf16), served by make_server on
          an ephemeral port; OpenAIInference plain and streamed on two
          clips, each alone with the prefix reuse off and the guard reset,
          equal to submit of the batch the server built, on the same engine.
      (d) _spec_serving.

    Returns (metrics, #11 / #12 launches at T = 9 in (d))."""
    import tempfile
    import threading

    import ultravox_torch
    from ultravox_torch.data.sample import VoiceSample
    from ultravox_torch.inference.serving import api_server
    from ultravox_torch.inference.ultravox_infer import UltravoxInference
    from ultravox_torch.tools.infer_api import OpenAIInference
    from ultravox_torch.tools.publish import save_pretrained

    t_phase = time.perf_counter()
    metrics = {}
    L_dec, new_tokens = cfg.text_config.num_layers, 32
    rng = np.random.default_rng(SEED + 11)
    clips = _audio(2, 10.0, rng)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {name: c.launches for name, c in counters.items()}

    with tempfile.TemporaryDirectory() as ckpt:
        # (a) the checkpoint directory
        params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16,
                                dev)
        t0 = time.perf_counter()
        save_pretrained(params, cfg, ckpt, dtype=None)
        _write_flagship_tokenizer(ckpt, cfg.vocab_size)
        del params
        torch.cuda.empty_cache()
        print(f"front doors (a): checkpoint with tokenizer written in "
              f"{time.perf_counter() - t0:.3f} s: {sorted(os.listdir(ckpt))}", flush=True)

        # (b) the offline doors
        t0 = time.perf_counter()
        inf = UltravoxInference(ckpt, max_cache_len=1024)
        load_s = time.perf_counter() - t0
        if len(inf.tokenizer) != cfg.vocab_size or inf.tokenizer.eos_token_id != 128009:
            _fail(f"front doors: the tokenizer has {len(inf.tokenizer)} ids, eos "
                  f"{inf.tokenizer.eos_token_id}")
        sample = VoiceSample.from_prompt_and_audio("Transcribe the following audio: <|audio|>",
                                                   clips[0])
        inf.infer(sample, max_tokens=2)  # warm-up
        out, secs, launches = counted(lambda: inf.infer(sample, max_tokens=new_tokens))
        sampled = out.output_tokens + (out.output_tokens < new_tokens)  # a stop token was sampled
        want = {name: 0 for name in counters}
        want.update(per_call)
        want["decode_attention"] = L_dec * (sampled - 1)
        print(f"front doors (b) infer: {out.input_tokens} prompt tokens, {out.output_tokens} "
              f"generated in {secs * 1e3:.3f} ms (load {load_s:.3f} s); text {out.text[:60]!r}; "
              f"launches {launches} expected {want}; phase 4's generate {gen_launches}", flush=True)
        for name, n in launches.items():
            if n != want[name]:
                _fail(f"front doors infer: {name} launched {n} times, expected {want[name]}")
        if sampled == new_tokens and any(launches[k] != gen_launches.get(k, 0) for k in want):
            _fail("front doors infer: launches differ from phase 4's generate")
        t0 = time.perf_counter()
        msgs = list(inf.infer_stream(sample, max_tokens=new_tokens))
        stream_s = time.perf_counter() - t0
        stats, chunks = msgs[-1], [m.text for m in msgs[:-1]]
        if not _stream_equal("".join(chunks), out.text):
            _fail("front doors: the streamed chunks do not join to infer's text")
        print(f"front doors (b) infer_stream: {len(chunks)} chunks {chunks[:4]}...; stats "
              f"{stats}; TTFT {stats.ttft_s * 1e3:.3f} ms, "
              f"{stats.output_tokens / stats.total_s:.2f} tok/s, {stream_s * 1e3:.3f} ms; {smi}",
              flush=True)
        inf.conversation_mode = True
        inf.update_conversation()
        turn1 = inf.infer(sample, max_tokens=new_tokens)
        pre1 = inf.last_prefilled_tokens
        turn2 = inf.infer(VoiceSample.from_prompt("Now say that again, shorter."),
                          max_tokens=new_tokens)
        pre2 = inf.last_prefilled_tokens
        print(f"front doors (b) conversation: turn 1 prefilled {pre1} of {turn1.input_tokens} "
              f"tokens, turn 2 {pre2} of {turn2.input_tokens} (its suffix); texts "
              f"{turn1.text[:40]!r} / {turn2.text[:40]!r}", flush=True)
        # turn 2's prompt starts with turn 1's whole prompt, which is cached
        if not (pre1 == turn1.input_tokens and 0 < pre2 <= turn2.input_tokens - turn1.input_tokens):
            _fail("front doors: the second conversation turn did not reuse the first's cache")
        inf.conversation_mode = False
        inf.update_conversation()
        t0 = time.perf_counter()
        pipe = ultravox_torch.pipeline(ckpt, max_cache_len=1024)
        text = pipe({"audio": (clips[1] * 32767).astype(np.int16), "sampling_rate": 16000,
                     "prompt": "What is said here?"}, max_new_tokens=new_tokens)
        print(f"front doors (b) pipeline: {text[:60]!r} in {time.perf_counter() - t0:.3f} s "
              "(load included)", flush=True)
        del pipe
        metrics["offline"] = {
            "load_s": load_s, "infer_ms": secs * 1e3, "infer_tokens": out.output_tokens,
            "stream_ttft_ms": stats.ttft_s * 1e3, "stream_total_ms": stats.total_s * 1e3,
            "stream_chunks": len(chunks), "conversation_prefilled": [pre1, pre2],
            "conversation_prompt_tokens": [turn1.input_tokens, turn2.input_tokens],
            "launches": launches,
        }

        # (d) speculative serving, on the loaded tree
        metrics["spec_serving"], t9 = _spec_serving(inf.engine.params, cfg, counters, per_call,
                                                    smi, dev)
        del inf
        torch.cuda.empty_cache()

        # (c) the command-line server
        # the attention flags left to "auto": on the card at 16 MiB of KV a
        # layer (8192 positions) it picks every kernel, the block kernel too
        api, args = api_server.build_api([
            "--model", ckpt, "--host", "127.0.0.1", "--port", "0", "--num-slots", "4",
            "--max-seq-len", "8192", "--page-size", "256", "--spec-decode", "ngram",
            "--spec-k", "8"])
        eng = api.engine
        kernels = {"cache_mode": "paged", "decode_attn_impl": "kernel",
                   "prefill_attn_impl": "fused", "encoder_attn_impl": "fused",
                   "block_attn_impl": "kernel", "decode_block_steps": 8}
        if (eng.spec_decode != "ngram" or eng.spec_k != 8 or eng.resolved_flags != kernels
                or eng.cache.k.dtype != torch.bfloat16):
            _fail(f"front doors: build_api made {eng.resolved_flags}, spec {eng.spec_decode}, "
                  f"cache {eng.cache.k.dtype}")
        eng.min_reuse_tokens = 1 << 30  # every prefill starts at 0
        submitted = []
        submit = eng.submit

        def spy(batch, **kw):
            req = submit(batch, **kw)
            submitted.append((batch, req))
            return req

        eng.submit = spy
        server = api_server.make_server(api, args.host, args.port)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            client = OpenAIInference(f"http://127.0.0.1:{port}", model="ultravox-torch",
                                     timeout=600)
            client.infer(sample, max_tokens=4)  # warm-up
            http = []
            for i, clip in enumerate(clips):
                s_i = VoiceSample.from_prompt_and_audio("Transcribe: <|audio|>", clip)
                del submitted[:]
                _reset_spec_guard(eng)
                t0 = time.perf_counter()
                plain = client.infer(s_i, max_tokens=new_tokens)
                plain_s = time.perf_counter() - t0
                _reset_spec_guard(eng)
                t0 = time.perf_counter()
                parts = list(client.infer_stream(s_i, max_tokens=new_tokens))
                stream_s = time.perf_counter() - t0
                streamed = "".join(p.text for p in parts[:-1])
                batch, req = submitted[0]
                _reset_spec_guard(eng)
                again = submit(dict(batch), max_tokens=new_tokens)
                ids = [ev.token_id for ev in eng.stream(again, timeout=600)
                       if ev.token_id is not None]
                direct = api.tokenizer.decode(ids, skip_special_tokens=True)
                ttft = (req.first_token_time - req.submit_time) * 1e3
                http.append({"ttft_ms": ttft, "plain_ms": plain_s * 1e3,
                             "stream_ms": stream_s * 1e3, "tokens": plain.output_tokens})
                print(f"front doors (c) request {i}: HTTP plain {plain.text[:40]!r} "
                      f"({plain.output_tokens} tokens, {plain_s * 1e3:.3f} ms, engine TTFT "
                      f"{ttft:.3f} ms), streamed in {len(parts) - 1} chunks ({stream_s * 1e3:.3f} "
                      f"ms), submit {direct[:40]!r}; {smi}", flush=True)
                if not (plain.text == direct and _stream_equal(streamed, direct)):
                    _fail(f"front doors (c): HTTP plain {plain.text!r}, streamed {streamed!r} "
                          f"and submit {direct!r} differ")
            st = _spec_stats(eng)
            print(f"front doors (c): the server's speculation {st}", flush=True)
            metrics["server"] = {"requests": http, "spec": st}
        finally:
            server.shutdown()
            server.server_close()
            eng.stop()
            thread.join(timeout=30)
        del api, eng
        torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 11: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, t9


# Phase 12's recipe: the port's copy of the JAX package's v0.6 recipe (KL at
# T 2, audio LoRA r 8 on q_proj / v_proj, remat, attn_impl flash,
# vocab_loss_chunk 256, bf16) at the flagship widths, on synthetic-asr.
TRAIN_LOOP_RECIPE = "ultravox_torch/training/configs/v0.6_llama3_8b_tpu.yaml"
TRAIN_LOOP_OVERRIDES = {
    "text_model": "", "audio_model": "", "projector_hidden_size": 3072,
    "data_sets": ["synthetic-asr"], "data_weights": None, "val_sets": ["synthetic-asr"],
    "batch_size": 8, "grad_accum_steps": 2, "max_steps": 3, "lr_warmup_steps": 0,
    "logging_steps": 1, "save_steps": 4, "val_steps": 6, "val_num_samples": 16,
    "report_logs_to": [],
}


def _flagship_hf_dicts():
    """(text, audio) HF config dicts of _flagship_config's towers."""
    text = {"model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
            "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32,
            "num_key_value_heads": 8, "head_dim": 64, "rope_theta": 500000.0,
            "rms_norm_eps": 1e-5, "tie_word_embeddings": True, "max_position_embeddings": 8192}
    audio = {"model_type": "whisper", "num_mel_bins": 80, "d_model": 768, "encoder_layers": 12,
             "encoder_attention_heads": 12, "encoder_ffn_dim": 3072,
             "max_source_positions": 1500}
    return text, audio


def _train_loop_argv(out_dir: str, tok_dir: str, **extra) -> list:
    """The training CLI's argv for phase 12, each value in YAML's flow
    style, which the config's reader parses back to the same value (JSON
    would not do: YAML reads 1e-05 as a string)."""
    import yaml

    text, audio = _flagship_hf_dicts()
    root = os.path.dirname(os.path.abspath(__file__))
    argv = ["--config_path", os.path.join(root, TRAIN_LOOP_RECIPE)]
    kv = dict(TRAIN_LOOP_OVERRIDES, text_model_config=text, audio_model_config=audio,
              tokenizer_path=tok_dir, output_dir=out_dir, **extra)
    for k, v in kv.items():
        argv += [f"--{k}", yaml.safe_dump(v, default_flow_style=True, width=1 << 30)]
    return argv


def _opt_snapshot(state) -> dict:
    """A copy of what a checkpoint holds, on the card."""
    import copy

    opt = state.opt_state
    return {"step": state.step, "count": opt.count, "mini_step": opt.mini_step,
            "trainable": {k: v.detach().clone() for k, v in state.trainable.items()},
            "adamw": copy.deepcopy(opt.adamw.state_dict()),
            "acc": None if opt.acc is None else [a.clone() for a in opt.acc]}


def _snapshot_diffs(a: dict, b: dict) -> list:
    """What differs, bit for bit, between two _opt_snapshot()s."""
    bad = [k for k in ("step", "count", "mini_step") if a[k] != b[k]]
    if sorted(a["trainable"]) != sorted(b["trainable"]):
        return bad + ["trainable leaves"]
    bad += [k for k in a["trainable"] if not torch.equal(a["trainable"][k], b["trainable"][k])]
    sa, sb = a["adamw"]["state"], b["adamw"]["state"]
    if sorted(sa) != sorted(sb):
        return bad + ["adamw state"]
    bad += [f"adamw {i} {k}" for i in sa for k in sa[i]
            if not torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))]
    if a["adamw"]["param_groups"] != b["adamw"]["param_groups"]:
        bad.append("adamw param_groups")
    if (a["acc"] is None) != (b["acc"] is None) or any(
            not torch.equal(x, y) for x, y in zip(a["acc"] or [], b["acc"] or [])):
        bad.append("accumulation buffers")
    return bad


# Phase 12's timing run: the recipe's own logging_steps, save_steps and
# val_steps (a read-back every 20 micro-steps, no checkpoint or validation
# inside the windows), TIMING_MAX_STEPS updates. Micro-step 1 warms up;
# the intervals after micro-steps TIMING_LOOP are the loop as a user runs
# it (no synchronisation of the script's); micro-steps TIMING_ALONE are
# timed alone, each between two synchronisations; micro-steps
# TIMING_TRACED are traced.
TIMING_MAX_STEPS = 20
TIMING_LOOP = range(2, 33)
TIMING_ALONE = range(33, 38)
TIMING_TRACED = range(38, 40)


def _train_loop_main_path(tc, counters, bare_step_ms, smi, dev):
    """Phase 12: the training CLI's loop, ``training/train.py::train``, at
    the flagship widths (whisper-small + Llama-3.2-1B as HF config dicts,
    _write_flagship_tokenizer's 128256 ids) on TRAIN_LOOP_RECIPE with
    TRAIN_LOOP_OVERRIDES: batch 8 of synthetic-asr, 2 micro-steps an update,
    3 updates (6 micro-steps), a checkpoint every 4 micro-steps, validation
    (16 samples) at micro-step 6.

      (a) #13's counts (and every other kernel's) set to 0 just before the
          first train() and read just after: forward 6 x (2 x 12 + 3 x 16)
          (encoder forward and remat recompute, student forward and
          recompute, teacher) + 2 validation batches x (12 + 16), backward
          6 x (12 + 16) x BWD_LAUNCHES; no other kernel.
      (b) on the loop's first collated batch and initial weights (a pack
          built from the same config), the loss and the trainable leaves'
          gradients through the kernels, forward and backward, against
          _FlashPlain (_flash_loss_vs_plain); micro-step 1's logged loss and
          grad_norm against the plain ones within FLASH_E2E_LOSS_RTOL and
          FLASH_E2E_GRAD_RTOL.
      (c) every logged loss, grad_norm and validation loss finite;
          train_config.json, train_log.jsonl, checkpoint-4, checkpoint-6
          and model.safetensors (multi_modal_projector.* keys) written.
      (d) a second train() from the first output (resume_from_load_dir,
          max_steps 4): the state it restores equals, bit for bit, the
          state the first run ended with (trainable leaves, AdamW moments,
          update count, step); it writes checkpoint-8.

    Then a third train(), for timing only (_train_loop_timing). Printed
    beside the card: the loop's ms a micro-step (host clock, the median of
    the intervals between step calls in TIMING_LOOP that hold no read-back,
    no pass end and no data set restart) and samples/s, and the whole
    window's mean; the step alone (median over TIMING_ALONE's full
    batches) beside phase 6's bare step; the loop's wait for each batch;
    the device's time a micro-step and its busy share over TIMING_TRACED;
    the data pipeline alone; peak memory; checkpoint write ms and MB,
    restore ms, validation ms (runs 1-2); the phase's seconds."""
    import shutil
    import tempfile

    from ultravox_torch.models import ultravox as uv
    from ultravox_torch.models.weights import read_safetensors
    from ultravox_torch.ops.kernels import flash_attention as fl
    from ultravox_torch.training import checkpoint as ckpt_lib
    from ultravox_torch.training import config as train_config
    from ultravox_torch.training import model_factory
    from ultravox_torch.training import train as train_mod
    from ultravox_torch.training import train_step as ts

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="train_loop_")
    metrics = {}
    try:
        tok = _write_flagship_tokenizer(os.path.join(root, "tok"))
        out1, out2, out3 = (os.path.join(root, f"run{i}") for i in (1, 2, 3))
        cfg1 = train_config.get_train_config(_train_loop_argv(out1, tok))
        if not (cfg1.device is None and cfg1.attn_impl == "flash" and cfg1.remat
                and cfg1.vocab_loss_chunk == 256 and cfg1.loss_function == "kl"
                and cfg1.param_dtype == "bfloat16" and cfg1.audio_model_lora["r"] == 8):
            _fail(f"phase 12: the recipe did not give the v0.6 settings: {cfg1}")

        # the data pipeline alone, and the first batch and weights for (b)
        t0 = time.perf_counter()
        pack = model_factory.create_model_pack(cfg1)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        if pack.config != _flagship_config(tc):
            _fail(f"phase 12: the model pack's config {pack.config} is not the flagship's")
        batches = train_mod.batch_iterator(train_mod.prepare_train_dataset(cfg1, pack),
                                           pack.collator, cfg1.batch_size)
        t0 = time.perf_counter()
        first = next(batches)
        first_batch_s = time.perf_counter() - t0
        n_timed = 6
        t0 = time.perf_counter()
        for _ in range(n_timed):
            next(batches)
        data_sps = n_timed * cfg1.batch_size / (time.perf_counter() - t0)
        batches.close()
        shapes = {k: tuple(v.shape) for k, v in first.items()}
        print(f"phase 12: model pack {pack_s:.3f} s; data pipeline alone (prepare_dataset + "
              f"collation, {cfg1.num_data_workers} threads, no card): first batch "
              f"{first_batch_s * 1e3:.3f} ms, then {data_sps:.3f} samples/s; batch {shapes}; "
              f"{smi}", flush=True)

        # (b), first half: the kernels' loss and gradients against the
        # plain versions' on the state train() starts from
        state0, template0 = ts.init_train_state(pack.params, ts.make_optimizer(),
                                                cfg1.effective_trainable_patterns, device=dev)
        vs_plain = _flash_loss_vs_plain(
            pack.config, tc, uv, ts, fl, state0, template0,
            train_mod.to_device(first, torch.device(dev)), lc=cfg1.loss_config,
            phase="phase 12")
        del pack, batches, state0, template0
        torch.cuda.empty_cache()

        # spies: saves, restores, validation (runs 1-2)
        saves, restores, vals, final = [], [], [], {}
        save, restore, validate = (ckpt_lib.save_checkpoint, ckpt_lib.restore_checkpoint,
                                   train_mod.validate)

        def timed_save(base, state):
            path = os.path.join(os.path.abspath(base), f"checkpoint-{state.step}")
            new = not os.path.exists(path)
            if state.step == cfg1.max_steps * cfg1.grad_accum_steps:  # run 1's final state
                final.setdefault("snapshot", _opt_snapshot(state))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = save(base, state)
            if new:
                mb = os.path.getsize(os.path.join(out, ckpt_lib.STATE_FILE)) / 1e6
                saves.append({"step": state.step, "ms": (time.perf_counter() - t0) * 1e3,
                              "mb": mb})
            return out

        def timed_restore(path, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(path, state)
            torch.cuda.synchronize()
            restores.append({"path": os.path.basename(path),
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "snapshot": _opt_snapshot(out)})
            return out

        def timed_validate(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate(*a, **kw)
            vals.append({"ms": (time.perf_counter() - t0) * 1e3, **out})
            return out

        ckpt_lib.save_checkpoint, ckpt_lib.restore_checkpoint = timed_save, timed_restore
        train_mod.validate = timed_validate
        try:
            # (a) the first run, every count from 0
            counters = dict(counters, flash_attention=fl.flash_attention)
            for c in counters.values():
                c.launches = 0
            fl.flash_attention.bwd_launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train_mod.train(cfg1)
            torch.cuda.synchronize()
            run1_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            launches = {name: c.launches for name, c in counters.items()}
            launches["flash_attention_bwd"] = fl.flash_attention.bwd_launches

            # (d) the second run, resumed from the first's output
            cfg2 = train_config.get_train_config(_train_loop_argv(
                out2, tok, model_load_dir=out1, resume_from_load_dir=True, max_steps=4))
            t0 = time.perf_counter()
            train_mod.train(cfg2)
            torch.cuda.synchronize()
            run2_s = time.perf_counter() - t0
        finally:
            ckpt_lib.save_checkpoint, ckpt_lib.restore_checkpoint = save, restore
            train_mod.validate = validate

        # (a)
        micro = cfg1.max_steps * cfg1.grad_accum_steps
        L_enc, L_dec = cfg1.audio_model_config["encoder_layers"], cfg1.text_model_config[
            "num_hidden_layers"]
        val_batches = -(-cfg1.val_num_samples // cfg1.batch_size)
        fwd_step, fwd_val, bwd_step = 2 * L_enc + 3 * L_dec, L_enc + L_dec, L_enc + L_dec
        want = {name: 0 for name in counters}
        want["flash_attention"] = micro * fwd_step + val_batches * fwd_val
        want["flash_attention_bwd"] = micro * bwd_step * fl.BWD_LAUNCHES
        print(f"launches, train loop ({micro} micro-steps x {fwd_step} forward calls + "
              f"{val_batches} validation batches x {fwd_val}; backward {micro} x {bwd_step} "
              f"calls x {fl.BWD_LAUNCHES} kernels): {launches} expected {want}", flush=True)
        if launches != want:
            _fail(f"phase 12: launches {launches}, expected {want}")

        # (c)
        with open(os.path.join(out1, "train_log.jsonl")) as f:
            log1 = [json.loads(line) for line in f]
        with open(os.path.join(out2, "train_log.jsonl")) as f:
            log2 = [json.loads(line) for line in f]
        steps = [r for r in log1 if "loss" in r]
        val_rows = [r for r in log1 if "val_loss/synthetic-asr" in r]
        for r in steps:
            print(f"train loop step {r['step']}: loss {r['loss']:.6f} grad_norm "
                  f"{r['grad_norm']:.6f} param_norm {r['param_norm']:.6f}", flush=True)
        if [r["step"] for r in steps] != list(range(1, micro + 1)):
            _fail(f"phase 12: logged micro-steps {[r['step'] for r in steps]}")
        if [r["step"] for r in log2 if "loss" in r] != [micro + 1, micro + 2]:
            _fail(f"phase 12: the resumed run logged {[r['step'] for r in log2]}")
        vals_ok = [r["val_loss/synthetic-asr"] for r in val_rows]
        if len(vals_ok) != 1 or val_rows[0]["step"] != micro:
            _fail(f"phase 12: validation rows {val_rows}")
        for r in steps + [r for r in log2 if "loss" in r]:
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0):
                _fail(f"phase 12: step {r['step']} logged loss {r['loss']} grad_norm "
                      f"{r['grad_norm']}")
        if not np.isfinite(vals_ok[0]):
            _fail(f"phase 12: validation loss {vals_ok[0]}")
        names = sorted(os.listdir(out1))
        for name in ("train_config.json", "train_log.jsonl", "checkpoint-4", "checkpoint-6",
                     "model.safetensors"):
            if name not in names:
                _fail(f"phase 12: {name} missing from the first run's output {names}")
        exported = read_safetensors(os.path.join(out1, "model.safetensors"))
        if not exported or not all(k.startswith("multi_modal_projector.") for k in exported):
            _fail(f"phase 12: model.safetensors holds {sorted(exported)}")
        if "checkpoint-8" not in os.listdir(out2):
            _fail(f"phase 12: the resumed run wrote {sorted(os.listdir(out2))}")

        # (b), second half: micro-step 1 as the loop logged it
        loss_rel = abs(steps[0]["loss"] - vs_plain["loss_plain"]) / abs(vs_plain["loss_plain"])
        norm_rel = (abs(steps[0]["grad_norm"] - vs_plain["grad_norm_plain"])
                    / vs_plain["grad_norm_plain"])
        print(f"train loop micro-step 1: logged loss {steps[0]['loss']:.6f} vs "
              f"{vs_plain['loss_plain']:.6f} through _FlashPlain (rel {loss_rel:.3g}, tol "
              f"{FLASH_E2E_LOSS_RTOL:.3g}); logged grad_norm {steps[0]['grad_norm']:.6f} vs "
              f"{vs_plain['grad_norm_plain']:.6f} through _FlashPlain (rel {norm_rel:.3g}, tol "
              f"{FLASH_E2E_GRAD_RTOL:.3g}) and {vs_plain['grad_norm_kernel']:.6f} through the "
              f"kernels outside the loop", flush=True)
        if not loss_rel <= FLASH_E2E_LOSS_RTOL:
            _fail(f"phase 12: micro-step 1's loss {steps[0]['loss']} vs the plain "
                  f"{vs_plain['loss_plain']}")
        if not norm_rel <= FLASH_E2E_GRAD_RTOL:
            _fail(f"phase 12: micro-step 1's grad_norm {steps[0]['grad_norm']} vs the plain "
                  f"{vs_plain['grad_norm_plain']}")

        # (d)
        if len(restores) != 1 or "snapshot" not in final:
            _fail(f"phase 12: {len(restores)} restores, final state captured: {'snapshot' in final}")
        diffs = _snapshot_diffs(final["snapshot"], restores[0]["snapshot"])
        print(f"train loop resume: restored {restores[0]['path']} (step "
              f"{restores[0]['snapshot']['step']}, {restores[0]['snapshot']['count']} updates, "
              f"{len(final['snapshot']['trainable'])} trainable leaves) in "
              f"{restores[0]['ms']:.3f} ms; {len(diffs)} differences from the first run's "
              f"final state {diffs[:8]}", flush=True)
        if diffs:
            _fail(f"phase 12: the restored state differs from the first run's: {diffs[:8]}")
        del final["snapshot"], restores[0]["snapshot"]

        timing = _train_loop_timing(tok, out3)
        print(f"train loop: {timing['micro_step_ms']:.3f} ms a micro-step (median of the "
              f"intervals after micro-steps {timing['clean']}), {timing['samples_per_s']:.3f} "
              f"samples/s; over the whole window, its read-back, pass ends, data set "
              f"restarts and the card's drain included, {timing['window_ms']:.3f} ms a "
              f"micro-step; the step alone {timing['step_alone_ms']:.3f} ms (median of "
              f"{timing['alone']}), the loop around it {timing['loop_around_step_ms']:.3f} ms; "
              f"phase 6's bare step (10 s audio, T 190) {bare_step_ms}; data set restarts (s "
              f"after micro-step {TIMING_LOOP[0]}'s call, start and first item) "
              f"{timing['restarts_s']}; every interval (after micro-step, ms, the loop's wait "
              f"for the next batch ms, batch size, what else it holds) {timing['intervals']}; "
              f"every step alone {timing['steps_alone_ms']}; {smi}", flush=True)
        print(f"train loop trace (micro-steps {list(TIMING_TRACED)} in the loop): device busy "
              f"{timing['device_busy_ms']:.3f} ms of {timing['traced_ms']:.3f} ms "
              f"({100 * timing['device_busy_share']:.1f}%; the optimizer's annotation span "
              f"{timing['annotated_ms']:.3f} ms, not counted): {timing['device_ms']:.3f} ms of "
              f"device time a micro-step, {100 * timing['busy_share_untraced']:.1f}% of the "
              f"untraced loop's median", flush=True)
        for key, count, ms in timing["top_kernels"]:
            print(f"  {ms:9.3f} ms  x{count:<6d} {key}", flush=True)
        print(f"train loop: peak memory {peak_gb:.3f} GB; checkpoint writes "
              f"{[(s['step'], round(s['ms'], 3), round(s['mb'], 3)) for s in saves]} (step, ms, "
              f"MB); restore {restores[0]['ms']:.3f} ms; validation "
              f"{[round(v['ms'], 3) for v in vals]} ms (loss {vals_ok[0]:.6f}); train() "
              f"{run1_s:.3f} s, {run2_s:.3f} s (resumed) and {timing['train_s']:.3f} s (timing, "
              f"{timing['micro_steps']} micro-steps); {smi}", flush=True)
        metrics = dict(
            timing, bare_step_phase6_ms=bare_step_ms, data_samples_per_s=data_sps,
            data_first_batch_ms=first_batch_s * 1e3, peak_memory_gb=peak_gb,
            checkpoint_writes=saves, restore_ms=restores[0]["ms"],
            validation_ms=[v["ms"] for v in vals], val_loss=vals_ok[0],
            losses=[r["loss"] for r in steps], grad_norms=[r["grad_norm"] for r in steps],
            flash_kernel_vs_plain=vs_plain, loss_step1_rel_err=loss_rel,
            grad_norm_step1_rel_err=norm_rel, train_s=[run1_s, run2_s, timing["train_s"]],
            batch_shapes=shapes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 12: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, launches


def _train_loop_timing(tok, out_dir):
    """Phase 12's third train(): the recipe's own logging, save and
    validation intervals, TIMING_MAX_STEPS updates, laid out by TIMING_*.
    A spy on the step records when the loop calls it and each batch's
    size; one on the prefetcher, how long the loop waited for each batch;
    one on the data set, when each pass over it starts and yields its
    first item (a restart: Dataproc's fresh pool deep-copies the processor
    on each thread, which holds the interpreter from the step). The
    interval after micro-step k runs from its call to the next and holds
    the step, the loop's bookkeeping, the wait for batch k + 1 and its copy
    to the card. The median leaves out the intervals that also hold a
    read-back, a pass's short last batch or part of a restart. The
    window's mean runs from micro-step TIMING_LOOP[0]'s call until the
    card has finished micro-step TIMING_LOOP[-1]."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from ultravox_torch.training import train as train_mod
    from ultravox_torch.training import train_step as ts
    from ultravox_torch.training.config import get_train_config

    base = get_train_config(["--config_path", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), TRAIN_LOOP_RECIPE)])
    cfg = get_train_config(_train_loop_argv(
        out_dir, tok, max_steps=TIMING_MAX_STEPS, logging_steps=base.logging_steps,
        save_steps=base.save_steps, val_steps=base.val_steps))
    micro = cfg.max_steps * cfg.grad_accum_steps
    if not (micro >= TIMING_TRACED[-1] + 1 and cfg.save_steps > micro
            and cfg.val_steps > micro):
        _fail(f"phase 12: the timing run's layout does not fit its config {cfg}")
    calls, sizes, alone, waits, trace, restarts = [], [], {}, [], {}, []
    make_step, prefetcher, batch_iterator = (ts.make_train_step, train_mod.Prefetcher,
                                             train_mod.batch_iterator)

    class TimedPasses:
        def __init__(self, dataset):
            self.dataset = dataset

        def __iter__(self):
            t0 = time.perf_counter()
            for i, item in enumerate(self.dataset):
                if i == 0:
                    restarts.append((t0, time.perf_counter()))
                yield item

    def timed_batches(dataset, *a, **kw):
        return batch_iterator(TimedPasses(dataset), *a, **kw)

    def timed_make(*a, **kw):
        fn = make_step(*a, **kw)

        def step(state, batch):
            calls.append(time.perf_counter())
            sizes.append(int(batch["input_ids"].shape[0]))
            n = len(calls)
            if n == TIMING_TRACED[0]:
                torch.cuda.synchronize()
                trace["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                trace["prof"].__enter__()
                trace["t0"] = time.perf_counter()
            elif n == TIMING_TRACED[-1] + 1:
                torch.cuda.synchronize()
                trace["ms"] = (time.perf_counter() - trace["t0"]) * 1e3
                trace["prof"].__exit__(None, None, None)
            if n not in TIMING_ALONE:
                return fn(state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trace.setdefault("drained", t0)
            out = fn(state, batch)
            torch.cuda.synchronize()
            alone[n] = (time.perf_counter() - t0) * 1e3
            return out

        return step

    class TimedPrefetcher(prefetcher):
        def __iter__(self):
            items = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(items)
                except StopIteration:
                    return
                waits.append((time.perf_counter() - t0) * 1e3)
                yield item

    ts.make_train_step, train_mod.Prefetcher = timed_make, TimedPrefetcher
    train_mod.batch_iterator = timed_batches
    try:
        t0 = time.perf_counter()
        train_mod.train(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        ts.make_train_step, train_mod.Prefetcher = make_step, prefetcher
        train_mod.batch_iterator = batch_iterator
        if "prof" in trace and "ms" not in trace:
            trace["prof"].__exit__(None, None, None)
    if len(calls) != micro or "ms" not in trace:
        _fail(f"phase 12: the timing run made {len(calls)} step calls, expected {micro}")

    # waits[k] is batch k + 1's; a batch smaller than batch_size ends a pass
    def holds(k):
        t0, t1 = calls[k - 1], calls[k]
        return [what for what, yes in (
            ("read-back", k == 1 or k % cfg.logging_steps == 0),
            ("pass end", sizes[k - 1] < cfg.batch_size),
            ("restart", any(a < t1 and b > t0 for a, b in restarts[1:]))) if yes]

    intervals = [(k, round((calls[k] - calls[k - 1]) * 1e3, 3), round(waits[k], 3),
                  sizes[k - 1], holds(k)) for k in TIMING_LOOP]
    clean = [k for k, _, _, _, what in intervals if not what]
    loop_ms = statistics.median(ms for k, ms, _, _, _ in intervals if k in clean)
    full = [n for n in TIMING_ALONE if sizes[n - 1] == cfg.batch_size]
    step_ms = statistics.median(alone[n] for n in full)
    evs, annotated_ms = _device_events(trace["prof"])
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "micro_step_ms": loop_ms, "samples_per_s": cfg.batch_size / loop_ms * 1e3,
        "window_ms": (trace["drained"] - calls[TIMING_LOOP[0] - 1]) * 1e3 / len(TIMING_LOOP),
        "step_alone_ms": step_ms, "loop_around_step_ms": loop_ms - step_ms,
        "clean": clean, "alone": full, "intervals": intervals,
        "restarts_s": [(round(a - calls[TIMING_LOOP[0] - 1], 3),
                        round(b - calls[TIMING_LOOP[0] - 1], 3)) for a, b in restarts[1:]],
        "steps_alone_ms": [round(alone[n], 3) for n in TIMING_ALONE],
        "device_ms": busy_ms / len(TIMING_TRACED),
        "busy_share_untraced": busy_ms / len(TIMING_TRACED) / loop_ms,
        "device_busy_ms": busy_ms, "traced_ms": trace["ms"],
        "device_busy_share": busy_ms / trace["ms"], "annotated_ms": annotated_ms,
        "top_kernels": [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in top],
        "train_s": train_s, "micro_steps": micro,
    }


# --------------------------------------------------------------------------
# Phase 13: the wav2vec2 tower and every path that carries it
# --------------------------------------------------------------------------

# The published towers, as their config.json files give them:
# facebook/wav2vec2-large-960h-lv60-self (the stable, LayerNorm variant) and
# facebook/wav2vec2-base-960h (the GroupNorm variant).
W2V_LARGE_LV60 = {
    "model_type": "wav2vec2", "hidden_size": 1024, "num_hidden_layers": 24,
    "num_attention_heads": 16, "intermediate_size": 4096, "conv_dim": [512] * 7,
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
    "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5,
}
W2V_BASE = dict(W2V_LARGE_LV60, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                intermediate_size=3072, conv_bias=False, feat_extract_norm="group",
                do_stable_layer_norm=False)
W2V_SECONDS = (10.0, 7.3, 4.1, 1.0)  # phase 13's four ragged requests
# the bf16 tower against the same weights in fp32 on the card: the bound the
# bf16 streaming encode is held to (phase 10); a row alone against its row
# of the padded batch, fp32 (cuDNN picks its convolution per shape)
W2V_RMS_TOL = 2.0**-5
W2V_ROW_RMS_TOL = 1e-4
W2V_SMALL_SCALE = {"audio_tower": 1.0, "projector": 2.0, "language_model": 8.0}


def _same_leaves(a, b) -> bool:
    """The two trees hold the very same tensors."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(x is y for x, y in zip(la, lb))


def _w2v_config(tc, audio: dict):
    """Phase 4's flagship decoder and projector over a wav2vec2 tower."""
    import dataclasses

    return dataclasses.replace(_flagship_config(tc), audio_config=tc.make_audio_config(audio))


def _w2v_audio(seconds, rng):
    """(N, 1, T) raw audio, row i the first seconds[i] of phase 4's
    synthesized speech, normalised per utterance and zero-padded as the
    processor's feature extractor gives it; and the lengths in samples."""
    from ultravox_torch.models.processor import RawAudioFeatureExtractor

    raw = _audio(len(seconds), max(seconds), rng)
    feats, lens = RawAudioFeatureExtractor()(
        [raw[i, : int(s * 16000)] for i, s in enumerate(seconds)])
    return feats.astype(np.float32), lens.astype(np.int32)


def _w2v_batch(cfg, feats, lens, prompt_len: int, rng):
    """A collated batch of raw audio spliced at position 4 of each prompt."""
    n = len(lens)
    frames = cfg.audio_config.feature_lengths(lens.astype(np.int64))
    return {
        "input_ids": rng.integers(1, cfg.vocab_size, (n, prompt_len)).astype(np.int64),
        "attention_mask": np.ones((n, prompt_len), np.int64),
        "audio_values": feats,
        "audio_lens": lens,
        "audio_token_len": (-(-frames // cfg.stack_factor)).astype(np.int32),
        "audio_token_start_idx": np.full((n,), 4, np.int32),
        "audio_chunk_batch_idx": np.arange(n, dtype=np.int32),
    }


def _w2v_flops(acfg, B: int, T_samples: int) -> dict:
    """Matmul and convolution FLOPs of one tower call on B rows of
    T_samples, by part (2 per multiply-add)."""
    conv, t, c_in = 0.0, T_samples, 1
    for c, k, st in zip(acfg.conv_dim, acfg.conv_kernel, acfg.conv_stride):
        t = (t - k) // st + 1
        conv += 2.0 * B * t * c * c_in * k
        c_in = c
    D, F_, L = acfg.hidden_size, acfg.ffn_dim, acfg.num_layers
    groups, k = acfg.num_conv_pos_embedding_groups, acfg.num_conv_pos_embeddings
    return {
        "conv_stack": conv + 2.0 * B * t * c_in * D,  # with the feature projection
        "pos_conv": 2.0 * B * t * D * (D // groups) * k,
        "layer_products": 2.0 * B * t * L * (4 * D * D + 2 * D * F_),
        "attention": 4.0 * B * L * t * t * D,
    }


def _w2v_device_ms(fn):
    """(device ms, top kernels) of one call of fn from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs, _ = _device_events(prof)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    return (sum(e.self_device_time_total for e in evs) / 1e3,
            [(e.key[:70], e.count, e.self_device_time_total / 1e3) for e in top])


def _w2v_tower(tc, w2v, smi, dev) -> dict:
    """Phase 13 (a): both published towers alone at full width on 4 ragged
    requests (W2V_SECONDS), random bf16 weights from the seed: the bf16
    tower against the same weights in fp32 on the card over every valid
    frame (relative RMS within W2V_RMS_TOL); for the layer variant each row
    alone, fp32, against its row of the padded batch (W2V_ROW_RMS_TOL);
    ms per call (CUDA events) and the device time of the conv stack, the
    positional conv and the rest (the 24 layers, the projection, masks)
    from torch.profiler, beside the FLOPs of each part."""
    feats, lens = _w2v_audio(W2V_SECONDS, np.random.default_rng(SEED + 13))
    audio32 = torch.from_numpy(feats[:, 0]).to(dev)
    audio = audio32.bfloat16()
    lens_t = torch.from_numpy(lens).to(dev)
    out = {}
    for name, d in (("large-lv60", W2V_LARGE_LV60), ("base", W2V_BASE)):
        acfg = tc.make_audio_config(d)
        p = w2v.init_params(acfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16, dev)
        p32 = _to_float(p)
        frames = [int(f) for f in acfg.feature_lengths(lens)]
        with torch.inference_mode():
            got = w2v.encoder_forward(p, acfg, audio, lens_t)
            ref = w2v.encoder_forward(p32, acfg, audio32, lens_t)
            torch.cuda.synchronize()
            valid_got = torch.cat([got[i, :f] for i, f in enumerate(frames)])
            valid_ref = torch.cat([ref[i, :f] for i, f in enumerate(frames)])
            rms = _rel_rms(valid_got, valid_ref)
            finite = bool(torch.isfinite(got).all())
            print(f"wav2vec2 {name}: out {tuple(got.shape)} {got.dtype}, frames {frames}; bf16 "
                  f"against fp32 on the card: relative RMS {rms:.5f} (tol {W2V_RMS_TOL:.5f})",
                  flush=True)
            if got.shape != (len(lens), frames[0], acfg.hidden_size) or not finite:
                _fail(f"wav2vec2 {name}: output {tuple(got.shape)}, finite {finite}")
            if not rms <= W2V_RMS_TOL:
                _fail(f"wav2vec2 {name}: the bf16 tower differs from fp32 by a relative RMS of {rms}")
            row_rms = None
            if acfg.do_stable_layer_norm:
                row_rms = [_rel_rms(w2v.encoder_forward(p32, acfg, audio32[i: i + 1, : lens[i]])[0],
                                    ref[i, :f]) for i, f in enumerate(frames)]
                print(f"wav2vec2 {name}: each row alone against its row of the padded batch (fp32): "
                      f"relative RMS {[f'{r:.2e}' for r in row_rms]} (tol {W2V_ROW_RMS_TOL:g})",
                      flush=True)
                if not max(row_rms) <= W2V_ROW_RMS_TOL:
                    _fail(f"wav2vec2 {name}: a row alone differs from its padded row: {row_rms}")
            h = torch.randn((len(lens), frames[0], acfg.hidden_size), device=dev,
                            dtype=torch.bfloat16)
            parts = {
                "tower": lambda: w2v.encoder_forward(p, acfg, audio, lens_t),
                "conv_stack": lambda: w2v.feature_extractor(p, acfg, audio),
                "pos_conv": lambda: w2v.pos_conv_embedding(p, acfg, h),
            }
            ms = {k: _time_ms(fn, iters=10) for k, fn in parts.items()}
            dev_ms, tops = {}, {}
            for k, fn in parts.items():
                dev_ms[k], tops[k] = _w2v_device_ms(fn)
            ms32 = _time_ms(lambda: w2v.encoder_forward(p32, acfg, audio32, lens_t), iters=3)
        flops = _w2v_flops(acfg, len(lens), audio.shape[-1])
        total = sum(flops.values())
        rest = dev_ms["tower"] - dev_ms["conv_stack"] - dev_ms["pos_conv"]
        print(f"wav2vec2 {name} ({smi}): {ms['tower']:.3f} ms per call of 4 requests (bf16; fp32 "
              f"{ms32:.3f} ms), {total / 1e12:.3f} TFLOP ({total / ms['tower'] / 1e9:.1f} TF/s); "
              f"device time {dev_ms['tower']:.3f} ms: conv stack {dev_ms['conv_stack']:.3f} ms "
              f"({flops['conv_stack'] / 1e12:.3f} TFLOP), positional conv {dev_ms['pos_conv']:.3f} "
              f"ms ({flops['pos_conv'] / 1e12:.3f} TFLOP), layers and the rest {rest:.3f} ms "
              f"({flops['layer_products'] / 1e12:.3f} TFLOP in products, "
              f"{flops['attention'] / 1e12:.3f} in attention); busy share of the call "
              f"{dev_ms['tower'] / ms['tower']:.3f}", flush=True)
        for k, top in tops.items():
            for key, count, t in top[:4]:
                print(f"  {name} {k}: {t:9.3f} ms x{count:<4d} {key}", flush=True)
        out[name] = {"rel_rms_bf16_vs_fp32": rms, "row_alone_rel_rms": row_rms, "ms": ms["tower"],
                     "fp32_ms": ms32, "part_ms": ms, "device_ms": dev_ms, "rest_device_ms": rest,
                     "tflop": {k: v / 1e12 for k, v in flops.items()}, "frames": frames,
                     "top_kernels": tops}
        del p, p32, got, ref
        torch.cuda.empty_cache()
    return out


def _w2v_small(tc, uv, TEngine, dev) -> None:
    """Phase 13 (b): a tiny wav2vec2 + llama model in each variant, fp32:
    greedy tokens of generate with the decode kernel, generate_fused and the
    ServingEngine in slots and paged modes (sample buckets) on the card
    equal those of the plain versions on the CPU."""
    from ultravox_torch.ops.kernels.decode_attention import decode_attention

    text = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True)
    for style in ("group", "layer"):
        tiny = {"model_type": "wav2vec2", "hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4, "intermediate_size": 128, "conv_dim": [32, 32, 32],
                "conv_kernel": [10, 3, 2], "conv_stride": [5, 2, 2],
                "conv_bias": style == "layer", "feat_extract_norm": style,
                "do_stable_layer_norm": style == "layer", "num_conv_pos_embeddings": 16,
                "num_conv_pos_embedding_groups": 4}
        cfg = tc.UltravoxConfig(audio_config=tc.make_audio_config(tiny),
                                text_config=tc.DecoderConfig(**text), hidden_size=256,
                                projector_ln_mid=True)
        params = uv.init_params(cfg, torch.Generator().manual_seed(SEED))
        params = {k: _scale(v, W2V_SMALL_SCALE[k]) for k, v in params.items()}
        rng = np.random.default_rng(SEED + 13)
        feats, lens = _w2v_audio((0.25, 0.16), rng)
        batch = _w2v_batch(cfg, feats, lens, 40, rng)
        toks = {}
        for device in ("cpu", dev):
            eng = TEngine(params, cfg, max_cache_len=128, cache_dtype=torch.float32,
                          encoder_attn_impl="fused", prefill_attn_impl="fused",
                          decode_attn_impl="kernel", device=device)
            before = decode_attention.launches
            toks[device] = {
                "generate": eng.generate(batch, max_new_tokens=12).token_ids,
                "generate_fused": eng.generate_fused(batch, max_new_tokens=12).token_ids,
            }
            if device != "cpu" and decode_attention.launches == before:
                _fail(f"small wav2vec2 {style}: decode_attention was not launched on the card")
        for path, cpu in toks["cpu"].items():
            print(f"small wav2vec2 {style} {path}: cpu {cpu} gpu {toks[dev][path]}", flush=True)
            if cpu != toks[dev][path]:
                _fail(f"small wav2vec2 {style} {path}: greedy tokens on the card differ from the "
                      "CPU's")
        _small_serving_parity(f"wav2vec2 {style}", params, cfg, [_row(batch, i) for i in range(2)],
                              dev, audio_buckets=(4800,))


def _w2v_main_path(tc, uv, counters, smi, dev):
    """Phase 13: the wav2vec2 tower at full width through every entry point
    that takes a tower (see the module docstring); returns (metrics,
    launches of the decoder kernels by path)."""
    from ultravox_torch.inference.engine import GenerationEngine
    from ultravox_torch.models import wav2vec2_encoder as w2v
    from ultravox_torch.ops.kernels import flash_attention as fl

    t_phase = time.perf_counter()
    metrics = {"tower": _w2v_tower(tc, w2v, smi, dev)}
    _w2v_small(tc, uv, GenerationEngine, dev)

    # (c) GenerationEngine at full width: large-lv60 + the flagship decoder
    cfg = _w2v_config(tc, W2V_LARGE_LV60)
    params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16, dev)
    tower_bytes = sum(_nbytes(t) for t in _leaves(params["audio_tower"]))
    counters = dict(counters, flash_attention=fl.flash_attention)
    L_dec = cfg.text_config.num_layers
    n_req, prompt_len, new_tokens = len(W2V_SECONDS), 128, 32
    steps = new_tokens - 1
    rng = np.random.default_rng(SEED + 13)
    feats, lens = _w2v_audio(W2V_SECONDS, rng)
    batch = _w2v_batch(cfg, feats, lens, prompt_len, rng)

    launches_by_path = {}
    engine = GenerationEngine(params, cfg, max_cache_len=1024, encoder_attn_impl="fused",
                              prefill_attn_impl="fused", decode_attn_impl="kernel", device=dev)
    if not _same_leaves(engine.params["audio_tower"], params["audio_tower"]):
        _fail("wav2vec2 generate: the engine replaced the tower (only a Whisper tower is fused)")
    engine.generate(batch, max_new_tokens=2)  # warm-up
    stamps = []
    torch.cuda.reset_peak_memory_stats()
    res, t0, t1, launches_by_path["generate"] = _counted_run(
        counters, "wav2vec2 generate(decode_attn_impl='kernel')",
        lambda: engine.generate(batch, max_new_tokens=new_tokens,
                                token_callback=lambda *a: stamps.append(time.perf_counter())),
        {"fused_attention": L_dec, "decode_attention": L_dec * steps})
    ids = res.token_ids
    if len(ids) != n_req or any(len(r) != new_tokens or not all(0 <= t < cfg.vocab_size for t in r)
                                for r in ids):
        _fail(f"wav2vec2 generate: tokens {[len(r) for r in ids]}")
    gen = {"ttft_ms": (stamps[0] - t0) * 1e3,
           "decode_tok_s": n_req * steps / (stamps[-1] - stamps[0]),
           "total_ms": (t1 - t0) * 1e3, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_tokens": [r[:8] for r in ids]}
    print(f"wav2vec2 generate ({smi}): {n_req} requests of {list(W2V_SECONDS)} s, prompt "
          f"{prompt_len}, {new_tokens} greedy tokens; TTFT {gen['ttft_ms']:.3f} ms; decode "
          f"{gen['decode_tok_s']:.2f} tok/s; total {gen['total_ms']:.3f} ms; peak memory "
          f"{gen['peak_memory_gb']:.3f} GB; first tokens {gen['first_tokens']}", flush=True)
    # the tower keeps its dtype under int8, as in the JAX engine
    eng8 = GenerationEngine(params, cfg, max_cache_len=1024, quantize="int8",
                            encoder_attn_impl="fused", prefill_attn_impl="fused",
                            decode_attn_impl="kernel", device=dev)
    bytes8 = sum(_nbytes(t) for t in _leaves(eng8.params["audio_tower"]))
    res8, _, _, _ = _counted_run(counters, "wav2vec2 generate, int8",
                                 lambda: eng8.generate(batch, max_new_tokens=4),
                                 {"fused_attention": L_dec, "decode_attention": L_dec * 3})
    print(f"wav2vec2 int8 engine: tower {bytes8} bytes (bf16 tree {tower_bytes}); first tokens "
          f"{[r[:4] for r in res8.token_ids]}", flush=True)
    if bytes8 != tower_bytes or not _same_leaves(eng8.params["audio_tower"], params["audio_tower"]):
        _fail("wav2vec2 int8: the engine changed the tower")
    gen["int8_tower_bytes"] = bytes8
    del eng8, engine
    torch.cuda.empty_cache()
    metrics["generate"] = gen

    metrics["serving"], launches_by_path["serving"] = _w2v_serving(cfg, params, counters, smi, dev)
    metrics["checkpoint"] = _w2v_checkpoint(cfg, params, dev)
    metrics["train"], launches_by_path["train"] = _w2v_train(tc, uv, cfg, params, smi, dev)
    del params
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, launches_by_path


def _w2v_serving(cfg, params, counters, smi, dev):
    """Phase 13 (d): a paged ServingEngine (the decode and segment kernels,
    sample buckets by default) on phase 5's traffic with the large tower: 8
    greedy requests of 10 s of audio in a 128-token prompt, 32 tokens each,
    4 slots. Launches against the engine's counters (#1-#3 none)."""
    from ultravox_torch.inference.serving.engine import SAMPLE_LEN_BUCKETS, ServingEngine

    n_req, prompt_len, new_tokens, K = 8, 128, 32, 8
    rng = np.random.default_rng(SEED + 5)
    feats, lens = _w2v_audio((10.0,) * n_req, rng)
    batch = _w2v_batch(cfg, feats, lens, prompt_len, rng)
    requests = [_row(batch, i) for i in range(n_req)]
    warm = [_row(dict(batch, input_ids=batch["input_ids"] % (cfg.vocab_size - 1) + 1), i)
            for i in range(2)]
    srv = ServingEngine(params, cfg, num_slots=4, max_seq_len=2048, page_size=256,
                        cache_mode="paged", prefill_chunk_tokens=64, decode_block_steps=K,
                        encoder_attn_impl="fused", prefill_attn_impl="fused",
                        decode_attn_impl="kernel", block_attn_impl="kernel", device=dev)
    if srv.mel_len_buckets != SAMPLE_LEN_BUCKETS:
        _fail(f"wav2vec2 serving: buckets {srv.mel_len_buckets}, expected samples")
    srv.start()
    try:
        _serve(srv, warm, 12)
        for c in counters.values():
            c.launches = 0
        for stat in ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks"):
            setattr(srv, stat, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _serve(srv, requests, new_tokens)
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        disp, steps, chunks = (srv.stat_decode_dispatches, srv.stat_decode_steps,
                               srv.stat_prefill_chunks)
        _check_pages(srv, "wav2vec2 serving")
    finally:
        srv.stop()
    singles, blocks = _check_serving_launches(
        "wav2vec2 paged+kernel", launches, counters, {}, disp, steps, chunks, K,
        cfg.text_config.num_layers, "paged_decode_attention", "paged_segment_tail_attention")
    for i, (ids, finish, _) in enumerate(out):
        if finish != "length" or len(ids) != new_tokens:
            _fail(f"wav2vec2 serving: request {i} finished {finish!r} with {len(ids)} tokens")
    ttft = sorted(t * 1e3 for _, _, t in out)
    m = {"ttft_p50_ms": float(np.median(ttft)), "ttft_max_ms": ttft[-1],
         "output_tok_s": n_req * new_tokens / wall, "wall_ms": wall * 1e3,
         "decode_dispatches": disp, "single_steps": singles, "blocks": blocks,
         "prefill_chunks": chunks}
    print(f"wav2vec2 serving ({smi}): {n_req} requests x {new_tokens} tokens in "
          f"{wall * 1e3:.3f} ms ({m['output_tok_s']:.2f} tok/s); TTFT p50 {m['ttft_p50_ms']:.3f} "
          f"ms, max {ttft[-1]:.3f} ms", flush=True)
    return m, launches


def _w2v_checkpoint(cfg, params, dev) -> dict:
    """Phase 13 (e): save_pretrained of the full-width tree (each leaf in its
    own dtype) loaded onto the card by load_ultravox_checkpoint bit for bit;
    a standalone Wav2Vec2ForCTC-layout tower file (``wav2vec2.`` prefix,
    weight_g / weight_v, fp32) written with save_safetensors and read
    through convert_audio_tower_checkpoint: every leaf bit-equal but the
    positional conv, rebuilt from g * v / ||v||, within one bf16 ulp."""
    import tempfile

    from ultravox_torch.inference.ultravox_infer import load_ultravox_checkpoint
    from ultravox_torch.models import weights as weights_lib
    from ultravox_torch.tools.publish import _wav2vec2_to_hf, save_pretrained

    m = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_pretrained(params, cfg, d, dtype=None)
        m["write_s"] = time.perf_counter() - t0
        m["bytes"] = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.perf_counter()
        lcfg, lparams, _ = load_ultravox_checkpoint(d, torch.bfloat16)
        torch.cuda.synchronize()
        m["load_s"] = time.perf_counter() - t0
    bad = _bits_differ(params, lparams)
    print(f"wav2vec2 checkpoint: {m['bytes']} bytes, write {m['write_s']:.3f} s, load onto the "
          f"card {m['load_s']:.3f} s; {len(_flat_paths(lparams))} leaves, {len(bad)} not "
          "bit-equal", flush=True)
    if bad or lcfg != cfg:
        _fail(f"wav2vec2 checkpoint: leaves {bad[:8]} differ, or the config {lcfg.audio_config}")
    del lparams
    sd = {f"wav2vec2.{k}": v for k, v in _wav2vec2_to_hf(params["audio_tower"], cfg).items()}
    sd["lm_head.weight"] = torch.zeros((32, cfg.audio_config.hidden_size))
    if "wav2vec2.encoder.pos_conv_embed.conv.weight_g" not in sd:
        _fail("wav2vec2 tower file: no weight_g")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.safetensors")
        weights_lib.save_safetensors(sd, path)
        tower = weights_lib.convert_audio_tower_checkpoint(
            weights_lib.read_safetensors(path), cfg.audio_config, torch.bfloat16, dev)
    want = params["audio_tower"]
    bad = [k for k in _bits_differ(want, tower) if k != "pos_conv/kernel"]
    a, b = tower["pos_conv"]["kernel"].float(), want["pos_conv"]["kernel"].float()
    ulps = float(((a - b).abs() / (2.0**-8 * b.abs()).clamp(min=2.0**-133)).max())
    print(f"wav2vec2 tower file (Wav2Vec2ForCTC layout, fp32): {len(sd)} tensors; leaves not "
          f"bit-equal {bad}; the positional conv within {ulps:.3g} bf16 ulps", flush=True)
    if bad or not ulps <= 1.0:
        _fail(f"wav2vec2 tower file: leaves {bad} differ, positional conv by {ulps} ulps")
    m["tower_file_pos_conv_ulps"] = ulps
    return m


def _w2v_train(tc, uv, cfg, params, smi, dev):
    """Phase 13 (f): three KL train steps at full width (large-lv60 + the
    flagship decoder, bf16, the projector trainable, remat, vocab chunk
    256, flash attention): 8 rows of 10 s of raw audio (499 frames, 63
    audio tokens at position 4), T 191, T2 128, 40 labelled tokens.
    flash_attention runs in the decoder only (the tower's attention is the
    plain mha, as in the JAX package): 3 x 16 forward and 16 x
    BWD_LAUNCHES backward launches a step. Then the first batch's loss and
    gradient norm through the kernels against _FlashPlain, as phase 6."""
    from ultravox_torch.ops.kernels import flash_attention as fl
    from ultravox_torch.training import train_step as ts

    opt = ts.make_optimizer(1e-4, warmup_steps=0, total_steps=100)
    state, template = ts.init_train_state(params, opt, (r".*projector/.*",), device=dev)
    step = ts.make_train_step(cfg, tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE),
                              opt, template, remat=True, attn_impl="flash", vocab_chunk=256)
    B, T2 = 8, 128
    rng = np.random.default_rng(SEED + 6)
    feats, lens = _w2v_audio((10.0,) * B, rng)
    n_tok = int(-(-cfg.audio_config.feature_lengths(160000) // cfg.stack_factor))
    T = 64 + n_tok + 64
    labels = np.full((B, T), -100, np.int64)
    labels[:, -40:] = rng.integers(1, cfg.vocab_size, (B, 40))
    alt_labels = np.full((B, T2), -100, np.int64)
    alt_labels[:, -40:] = labels[:, -40:]
    batch = _w2v_batch(cfg, feats, lens, T, rng)
    batch.update(labels=labels, alt_input_ids=rng.integers(1, cfg.vocab_size, (B, T2)),
                 alt_attention_mask=np.ones((B, T2), np.int64), alt_labels=alt_labels)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    vs_plain = _flash_loss_vs_plain(cfg, tc, uv, ts, fl, state, template, batch,
                                    phase="phase 13")
    L_dec = cfg.text_config.num_layers
    fl.flash_attention.launches = fl.flash_attention.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    launches = {"flash_attention": fl.flash_attention.launches,
                "flash_attention_bwd": fl.flash_attention.bwd_launches}
    want = {"flash_attention": 3 * 3 * L_dec,
            "flash_attention_bwd": 3 * L_dec * fl.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"launches, wav2vec2 train, 3 steps: {launches} expected {want}", flush=True)
    if launches != want:
        _fail(f"wav2vec2 train: flash_attention launches {launches}, expected {want}")
    if not all(np.isfinite(l) and g > 0 for l, g in losses):
        _fail(f"wav2vec2 train: (loss, grad_norm) {losses}")
    step_ms = [t * 1e3 for t in times]
    print(f"wav2vec2 train ({smi}): B {B} x 10 s, T {T}, T2 {T2}; (loss, grad_norm) {losses}; "
          f"step ms {[f'{t:.3f}' for t in step_ms]} (the first after the kernel-vs-plain call), "
          f"peak memory {peak:.3f} GB", flush=True)
    del state
    torch.cuda.empty_cache()
    return ({"step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
             "peak_memory_gb": peak, "losses": losses, "flash_kernel_vs_plain": vs_plain},
            launches)


# --------------------------------------------------------------------------
# Phase 14: several processes over NCCL, one a card
# --------------------------------------------------------------------------

MP_EVAL_SAMPLES, MP_EVAL_BATCH, MP_EVAL_TOKENS = 16, 8, 16
MP_TIMEOUT_S = 600


def _kernel_counters():
    """Every kernel wrapper with a launch count, by name (as main's)."""
    from ultravox_torch.ops.kernels import decode_attention as da
    from ultravox_torch.ops.kernels import decode_matmul as dm
    from ultravox_torch.ops.kernels import encoder_attn_probe as eap
    from ultravox_torch.ops.kernels import flash_attention as fl
    from ultravox_torch.ops.kernels import fused_attention as fa
    from ultravox_torch.ops.kernels import layer_norm as ln_mod
    from ultravox_torch.ops.kernels import paged_attention as pa
    from ultravox_torch.ops.kernels import paged_gather as pg
    from ultravox_torch.ops.kernels import segment_attention as sa

    return {
        "fused_layer_norm": ln_mod.fused_layer_norm, "ln_qkv_head_fused": fa.ln_qkv_head_fused,
        "qkv_head_transpose": fa.qkv_head_transpose,
        "attention_headmajor": fa.attention_headmajor, "fused_attention": fa.fused_attention,
        "decode_attention": da.decode_attention,
        "segment_tail_attention": sa.segment_tail_attention,
        "paged_decode_attention": pa.paged_decode_attention,
        "paged_segment_tail_attention": sa.paged_segment_tail_attention,
        "gather_pages": pg.gather_pages, "flash_attention": fl.flash_attention,
        "ln_matmul_gelu": fa.ln_matmul_gelu, "attn_out_proj_residual": fa.attn_out_proj_residual,
        "decode_matmul": dm.decode_matmul, "attn_v2": eap.attn_v2, "attn_nt": eap.attn_nt,
    }


def _count_launches(counters, fn):
    """fn() with every count (and #13's backward) set to 0 just before and
    read just after: (result, {name: launches})."""
    flash = counters["flash_attention"]
    for c in counters.values():
        c.launches = 0
    flash.bwd_launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    launches["flash_attention_bwd"] = flash.bwd_launches
    return out, launches


def _phase14_rank(spec_path: str) -> None:
    """One rank of phase 14, started by _multiprocess_main_path with
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): (a) train() on phase 12's run-1 config with mesh_fsdp -1
    and a checkpoint at micro-step 4, each step call timed between two
    synchronisations; (c) the eval CLI's main() on the flagship checkpoint,
    each generate call's token counts and each batch's seconds recorded.
    Writes its counts, times and facts to <out>.<rank> as JSON."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ultravox_torch.evaluation import eval as eval_mod
    from ultravox_torch.inference.engine import GenerationEngine
    from ultravox_torch.inference.infer import LocalInference
    from ultravox_torch.training import config as train_config
    from ultravox_torch.training import train as train_mod
    from ultravox_torch.training import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    counters = _kernel_counters()
    out = {"rank": rank}

    # (a) train() through parallel/
    cfg = train_config.get_train_config(spec["train_argv"])
    step_ms, last = [], {}
    make_step = ts.make_train_step

    def timed_make(*a, **kw):
        fn = make_step(*a, **kw)
        last["mesh"] = kw["mesh"]

        def step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            last["state"] = res[0]
            return res

        return step

    ts.make_train_step = timed_make
    try:
        t0 = time.perf_counter()
        _, out["train_launches"] = _count_launches(counters, lambda: train_mod.train(cfg))
        out["train_s"] = time.perf_counter() - t0
    finally:
        ts.make_train_step = make_step
    out.update(step_ms=step_ms, world=dist.get_world_size(), backend=dist.get_backend(),
               device=torch.cuda.current_device(), local_rank=int(os.environ["LOCAL_RANK"]),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    # what the group adds to a step, timed alone: the gradients' all-reduce
    # (one flat bucket a dtype) and the three scalar ones of the KL loss
    # (the two counts and the logged loss); none at world 1, where the mesh
    # has no groups
    from ultravox_torch.parallel.sharding import all_reduce_, reduce_gradients

    mesh, leaves = last["mesh"], list(last["state"].trainable.values())
    grads = [t.detach().clone() for t in leaves]
    scalar = torch.ones((), device=leaves[0].device)

    def added():
        reduce_gradients(leaves, grads, mesh)
        for _ in range(3):
            all_reduce_(scalar.clone(), mesh.batch_group)

    out["group_ms"] = _time_ms(added)
    out["grad_bucket_mb"] = sum(g.numel() * g.element_size() for g in grads) / 1e6
    del last, leaves, grads
    torch.cuda.empty_cache()

    # (c) the evaluation CLI
    calls, batch_s = [], []
    generate, infer_batch = GenerationEngine.generate, LocalInference.infer_batch

    def spy_generate(self, batch, **kw):
        res = generate(self, batch, **kw)
        calls.append({"max_new_tokens": kw["max_new_tokens"],
                      "tokens": [len(ids) for ids in res.token_ids]})
        return res

    def timed_batch(self, samples, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = infer_batch(self, samples, *a, **kw)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        return res

    GenerationEngine.generate, LocalInference.infer_batch = spy_generate, timed_batch
    sys.argv = ["eval", "--model", spec["model"], "--eval_sets", "[synthetic-asr]",
                "--num_samples", str(MP_EVAL_SAMPLES), "--batch_size", str(MP_EVAL_BATCH),
                "--max_tokens", str(MP_EVAL_TOKENS), "--output_dir", spec["eval_dir"]]
    try:
        t0 = time.perf_counter()
        _, out["eval_launches"] = _count_launches(counters, eval_mod.main)
        out["eval_s"] = time.perf_counter() - t0
    finally:
        GenerationEngine.generate, LocalInference.infer_batch = generate, infer_batch
    out.update(generate_calls=calls, batch_s=batch_s)
    with open(f"{spec['out']}.{rank}", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _phases_12_14(tc, uv, dev) -> None:
    """Phases 12 and 14 alone, after the build (``--phases 12,14``): for
    working on phase 14 in a shorter call. Prints no result line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    cfg = _flagship_config(tc)
    counters = {k: v for k, v in _kernel_counters().items() if k != "flash_attention"}
    L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
    prefill = {"fused_layer_norm": L_enc, "ln_qkv_head_fused": L_enc,
               "attention_headmajor": L_enc, "fused_attention": L_dec}
    train_loop, _ = _train_loop_main_path(tc, counters, None, smi, dev)
    _multiprocess_main_path(tc, uv, cfg, counters, prefill, train_loop, smi, dev)
    print("chip_smoke: phases 12 and 14 only, no result", flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(spec: dict, root: str, n: int, phase: int = 14, one_card: bool = False) -> list:
    """Start n ranks of this script (--phase<phase>-rank), one a card (or
    all on cuda:0 with ``one_card``), with torchrun's environment; wait for
    all, kill all on a failure or at MP_TIMEOUT_S; their results in rank
    order."""
    path = os.path.join(root, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs, logs = [], []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(0 if one_card else rank), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(os.path.join(root, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       f"--phase{phase}-rank", path], env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.time() + MP_TIMEOUT_S
    failed = False
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p in procs):
                failed = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = []
    for rank, log in enumerate(logs):
        log.seek(0)
        tails.append(log.read()[-6000:])
        log.close()
    if failed or any(p.returncode != 0 for p in procs):
        for rank, tail in enumerate(tails):
            print(f"--- phase {phase} rank {rank} (return code {procs[rank].returncode}):\n{tail}",
                  file=sys.stderr, flush=True)
        _fail(f"phase {phase}: ranks ended with {[p.returncode for p in procs]}"
              f"{' (timed out)' if time.time() > deadline else ''}")
    for rank, tail in enumerate(tails):  # a rank's own lines, for the record
        for line in tail.splitlines():
            if line.startswith(f"phase {phase}"):
                print(f"[rank {rank}] {line}", flush=True)
    out = []
    for rank in range(n):
        with open(f"{spec['out']}.{rank}") as f:
            out.append(json.load(f))
    return out


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x == y for x, y in zip(a, b))


def _multiprocess_main_path(tc, uv, cfg, counters, prefill, train_loop, smi, dev):
    """Phase 14: the data x fsdp layer over NCCL, one process a card (as
    many as torch.cuda.device_count(); 1 on a one-card machine, where the
    mesh has no groups and no step issues a collective), through the
    user's entry points:

      (a) train() in each rank (torchrun's environment, initialize_multihost
          -> NCCL on cuda:LOCAL_RANK, make_mesh, shard_params, the gathers
          at _layer, the reductions), on phase 12's run-1 config with
          mesh_fsdp -1: 6 micro-steps (3 updates), a checkpoint at 4 written
          through the gather, validation at 6. #13's launches as phase 12's
          (and no other kernel's); every logged loss and grad_norm and the
          validation loss against phase 12's run 1 (bit for bit at world 1);
          each step call timed between two synchronisations, beside phase
          12's step alone: what the process group costs.
      (b) checkpoint-4 resumed in this process, with no process group: the
          next step (micro-step 5 on the data's 5th batch) equal to the
          rank's logged micro-step 5 (bit for bit at world 1).
      (c) python -m ultravox_torch.evaluation.eval's main() in each rank on
          a flagship checkpoint (phase 9's tree from the seed, phase 11's
          128256-id tokenizer), 16 synthetic-asr samples in batches of 8,
          greedy, 16 tokens, WER: #1-#4 and #8 launched as phase 11's
          UltravoxInference counts them for each generate call, no other
          kernel; rank 0 alone wrote synthetic-asr.json and summary.json,
          16 samples in index order; samples/s.

    Returns (metrics, {path: launches})."""
    import shutil
    import tempfile

    from ultravox_torch.training import checkpoint as ckpt_lib
    from ultravox_torch.training import config as train_config
    from ultravox_torch.training import model_factory
    from ultravox_torch.training import train as train_mod
    from ultravox_torch.training import train_step as ts
    from ultravox_torch.tools.publish import save_pretrained

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    print(f"phase 14: {n} process(es), one a card, NCCL, torchrun's environment; {smi}",
          flush=True)
    root = tempfile.mkdtemp(prefix="multiproc_")
    try:
        tok = _write_flagship_tokenizer(os.path.join(root, "tok"))
        out_train, ckpt, eval_dir = (os.path.join(root, d) for d in ("train", "ckpt", "eval"))
        t0 = time.perf_counter()
        params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16,
                                dev)
        save_pretrained(params, cfg, ckpt, dtype=None)
        _write_flagship_tokenizer(ckpt, cfg.vocab_size)
        del params
        torch.cuda.empty_cache()
        ckpt_s = time.perf_counter() - t0
        argv = _train_loop_argv(out_train, tok, mesh_fsdp=-1)
        spec = {"train_argv": argv, "model": ckpt, "eval_dir": eval_dir,
                "out": os.path.join(root, "result.json")}
        t0 = time.perf_counter()
        ranks = _run_ranks(spec, root, n)
        ranks_s = time.perf_counter() - t0
        r0 = ranks[0]

        # (a)
        cfg14 = train_config.get_train_config(argv)
        micro = cfg14.max_steps * cfg14.grad_accum_steps
        L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
        fwd_step, fwd_val, bwd_step = 2 * L_enc + 3 * L_dec, L_enc + L_dec, L_enc + L_dec
        val_batches = -(-(cfg14.val_num_samples // n) // (cfg14.batch_size // n))
        from ultravox_torch.ops.kernels import flash_attention as fl

        want = {name: 0 for name in r0["train_launches"]}
        want["flash_attention"] = micro * fwd_step + val_batches * fwd_val
        want["flash_attention_bwd"] = micro * bwd_step * fl.BWD_LAUNCHES
        facts = [(r["world"], r["backend"], r["device"], r["local_rank"]) for r in ranks]
        print(f"phase 14 (a): world {n}; ranks (world, backend, device, LOCAL_RANK) {facts}; "
              f"launches {r0['train_launches']} expected {want}", flush=True)
        if any(f != (n, "nccl", i, i) for i, f in enumerate(facts)):
            _fail(f"phase 14: the ranks ran as {facts}")
        for r in ranks:
            if r["train_launches"] != want:
                _fail(f"phase 14: rank {r['rank']} train launches {r['train_launches']}, "
                      f"expected {want}")
        with open(os.path.join(out_train, "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        steps = [r for r in log if "loss" in r]
        losses, norms = [r["loss"] for r in steps], [r["grad_norm"] for r in steps]
        val = [r["val_loss/synthetic-asr"] for r in log if "val_loss/synthetic-asr" in r]
        bits = (_same(losses, train_loop["losses"]) and _same(norms, train_loop["grad_norms"])
                and _same(val, [train_loop["val_loss"]]))
        rel = max([abs(a - b) / abs(b) for a, b in zip(losses + norms + val, train_loop["losses"]
                                                        + train_loop["grad_norms"]
                                                        + [train_loop["val_loss"]])] or [np.inf])
        print(f"phase 14 (a): losses {losses}; grad_norms {norms}; val_loss {val}; phase 12 run 1 "
              f"{train_loop['losses']} / {train_loop['grad_norms']} / {train_loop['val_loss']}: "
              f"bit for bit {bits}, largest relative difference {rel:.3g}", flush=True)
        if len(steps) != micro or len(val) != 1 or not np.isfinite(rel):
            _fail(f"phase 14: logged {len(steps)} micro-steps and {len(val)} validations")
        if (n == 1 and not bits) or rel > FLASH_E2E_LOSS_RTOL:
            _fail(f"phase 14: the losses differ from phase 12's (largest relative difference "
                  f"{rel}; world {n})")
        for name in ("checkpoint-4", "checkpoint-6", "model.safetensors", "train_config.json"):
            if not os.path.exists(os.path.join(out_train, name)):
                _fail(f"phase 14: {name} missing from {sorted(os.listdir(out_train))}")
        step_ms = r0["step_ms"]
        mp_step = float(np.median(step_ms[1:]))
        print(f"phase 14 (a): step call ms (synced) {[round(t, 3) for t in step_ms]}; median of "
              f"micro-steps 2-{micro} {mp_step:.3f} ms against phase 12's step alone "
              f"{train_loop['step_alone_ms']:.3f} ms ({mp_step - train_loop['step_alone_ms']:+.3f} "
              f"ms; phase 12's loop {train_loop['micro_step_ms']:.3f} ms a micro-step); the "
              f"group's own work timed alone (the {r0['grad_bucket_mb']:.3f} MB gradient bucket's "
              f"all-reduce and three scalar ones, none issued at world 1) "
              f"{r0['group_ms']:.4f} ms; train() "
              f"{r0['train_s']:.3f} s, peak memory {r0['peak_memory_gb']:.3f} GB; {smi}",
              flush=True)

        # (b) resume in this process, no process group
        t0 = time.perf_counter()
        pack = model_factory.create_model_pack(cfg14)
        optimizer = train_mod.make_train_optimizer(cfg14)
        state, template = ts.init_train_state(pack.params, optimizer,
                                              cfg14.effective_trainable_patterns, device=dev)
        state = ckpt_lib.restore_checkpoint(os.path.join(out_train, "checkpoint-4"), state)
        step_fn = ts.make_train_step(pack.config, cfg14.loss_config, optimizer, template,
                                     remat=cfg14.remat, attn_impl=cfg14.attn_impl,
                                     vocab_chunk=cfg14.vocab_loss_chunk)
        batches = train_mod.batch_iterator(train_mod.prepare_train_dataset(cfg14, pack),
                                           pack.collator, cfg14.batch_size)
        batch5 = [next(batches) for _ in range(5)][-1]
        batches.close()
        state, m = step_fn(state, train_mod.to_device(batch5, torch.device(dev)))
        resumed = (float(m["loss"]), float(m["grad_norm"]))
        logged = (steps[4]["loss"], steps[4]["grad_norm"])
        resume_s = time.perf_counter() - t0
        print(f"phase 14 (b): checkpoint-4 (step {state.step - 1}) resumed in one process "
              f"without a process group; micro-step 5 (loss, grad_norm) {resumed} against the "
              f"rank's {logged}; {resume_s:.3f} s", flush=True)
        if state.step != 5 or (n == 1 and resumed != logged) or abs(
                resumed[0] - logged[0]) > FLASH_E2E_LOSS_RTOL * abs(logged[0]):
            _fail(f"phase 14: the resumed micro-step 5 {resumed} differs from the run's {logged}")
        del pack, state, template, step_fn, m
        torch.cuda.empty_cache()

        # (c)
        want_eval = {name: 0 for name in r0["eval_launches"]}
        for call in r0["generate_calls"]:
            for name, k in prefill.items():
                want_eval[name] += k
            cap = call["max_new_tokens"]
            sampled = max(min(t + 1, cap) for t in call["tokens"])
            want_eval["decode_attention"] += L_dec * (sampled - 1)
        names = sorted(os.listdir(eval_dir))
        with open(os.path.join(eval_dir, "synthetic-asr.json")) as f:
            result = json.load(f)
        with open(os.path.join(eval_dir, "summary.json")) as f:
            summary = json.load(f)
        sps = MP_EVAL_SAMPLES / max(sum(r["batch_s"]) for r in ranks)
        print(f"phase 14 (c): eval CLI, {MP_EVAL_SAMPLES} synthetic-asr samples in batches of "
              f"{MP_EVAL_BATCH}, greedy, {MP_EVAL_TOKENS} tokens; generate calls "
              f"{r0['generate_calls']}; launches {r0['eval_launches']} expected {want_eval}; "
              f"files {names}; WER {summary.get('synthetic-asr', {}).get('score')} (random "
              f"weights); batch seconds {[round(t, 4) for t in r0['batch_s']]}; {sps:.3f} "
              f"samples/s; main() {r0['eval_s']:.3f} s; {smi}", flush=True)
        if r0["eval_launches"] != want_eval or not r0["generate_calls"]:
            _fail(f"phase 14: eval launches {r0['eval_launches']}, expected {want_eval}")
        if names != ["summary.json", "synthetic-asr.json"]:
            _fail(f"phase 14: the eval wrote {names}")
        idx = [smp["index"] for smp in result["samples"]]
        if idx != list(range(MP_EVAL_SAMPLES)) or result["num_samples"] != MP_EVAL_SAMPLES:
            _fail(f"phase 14: the eval JSON holds samples {idx}")
        if sorted(summary) != ["synthetic-asr"] or not np.isfinite(summary["synthetic-asr"]["score"]):
            _fail(f"phase 14: summary.json {summary}")
        metrics = {
            "world": n, "checkpoint_write_s": ckpt_s, "ranks_s": ranks_s,
            "train": {"losses": losses, "grad_norms": norms, "val_loss": val[0],
                      "bit_equal_phase12": bits, "max_rel_diff_phase12": rel,
                      "step_ms": step_ms, "step_ms_median": mp_step,
                      "phase12_step_alone_ms": train_loop["step_alone_ms"],
                      "group_ms": r0["group_ms"], "grad_bucket_mb": r0["grad_bucket_mb"],
                      "train_s": r0["train_s"], "peak_memory_gb": r0["peak_memory_gb"]},
            "resume": {"resumed": resumed, "logged": logged, "s": resume_s},
            "eval": {"samples_per_s": sps, "batch_s": r0["batch_s"], "eval_s": r0["eval_s"],
                     "wer": summary["synthetic-asr"]["score"],
                     "generate_calls": r0["generate_calls"]},
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, {"train": r0["train_launches"], "eval": r0["eval_launches"]}


def _to_float(tree):
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


# --------------------------------------------------------------------------
# phase 15: the tensor axis (Megatron splits in both towers), two ranks
# --------------------------------------------------------------------------

TP_SEED = 15
TP_TRAIN_STEPS = 3
TP_REQ, TP_SECONDS, TP_PROMPT, TP_NEW = 4, 10.0, 128, 32
# tensor 2's bf16 logits against one process's fp32 ones, at most this
# factor times one process's own bf16 distance from them: the row-split
# products round their partial sums to bf16 once more before the
# all-reduce (80 more roundings in 40 layers), nothing else differs
TP_LOGITS_FACTOR = 1.5
TP_SERVING = (  # (label, engine options); spec decoding with the guard off
    ("slots", dict(cache_mode="slots")),
    ("paged", dict(cache_mode="paged", page_size=256)),
    ("slots+spec", dict(cache_mode="slots", spec_decode="ngram", spec_min_accept=0)),
    ("paged+spec", dict(cache_mode="paged", page_size=256, spec_decode="ngram",
                        spec_min_accept=0)),
)


def _tp_config(tc):
    """The model of v0.6_qwen3_32b_tpu.yaml: Qwen3-32B at its published
    widths (8 of its 64 layers), whisper-large-v3-turbo's encoder, the
    4096-wide projector with ln_mid."""
    return tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(
            num_mel_bins=128, d_model=1280, num_layers=32, num_heads=20, ffn_dim=5120,
            max_source_positions=1500,
        ),
        text_config=tc.DecoderConfig(
            arch="qwen3", vocab_size=151936, hidden_size=5120, intermediate_size=25600,
            num_layers=8, num_heads=64, num_kv_heads=8, head_dim=128, rope_theta=1000000.0,
            rms_norm_eps=1e-6, qk_norm=True, tie_word_embeddings=False,
            max_position_embeddings=40960,
        ),
        hidden_size=4096,
        projector_ln_mid=True,
    )


def _tp_params(tc, uv, cfg, dev, seed=TP_SEED):
    """Phase 15's (and 16's) weights from the seed (bf16, the fp32 audio
    LoRA of the recipe: r 8 on q_proj / v_proj), whole: the same in every
    process."""
    from ultravox_torch.models import lora

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = uv.init_params(cfg, gen, torch.bfloat16, dev)
    return lora.apply_lora_to_model(
        params, tc.LoraConfig(), tc.LoraConfig(r=8, lora_alpha=8.0,
                                               target_modules=("q_proj", "v_proj")), gen)


def _tp_base(tree):
    """The tree without its LoRA leaves: the served model is the base one,
    whose encoder q/k/v fuse (a LoRA'd projection does not)."""
    if isinstance(tree, dict):
        return {k: _tp_base(v) for k, v in tree.items()
                if k not in ("lora_a", "lora_b", "lora_scale")}
    return tree


def _tp_mel(n, seconds, rng, dev):
    from ultravox_torch.ops.mel import log_mel_spectrogram

    return log_mel_spectrogram(torch.from_numpy(_audio(n, seconds, rng)).to(dev),
                               num_mel_filters=128)


def _tp_train_batch(cfg, step: int, dev, B: int = 2, seed: int = TP_SEED):
    """A KL batch of B rows of 10 s audio (1000 mel frames of 128 bins, 63
    audio tokens at position 4), T 191, T2 128, 40 labelled tokens."""
    mel_frames = 1000
    n_tok = -(-mel_frames // 2 // 8)
    T, T2 = 64 + n_tok + 64, 128
    rng = np.random.default_rng(seed + 100 + step)
    labels = np.full((B, T), -100, np.int64)
    labels[:, -40:] = rng.integers(1, cfg.vocab_size, (B, 40))
    alt_labels = np.full((B, T2), -100, np.int64)
    alt_labels[:, -40:] = labels[:, -40:]
    batch = {k: torch.as_tensor(v).to(dev) for k, v in {
        "input_ids": rng.integers(1, cfg.vocab_size, (B, T)),
        "attention_mask": np.ones((B, T), np.int64),
        "labels": labels,
        "alt_input_ids": rng.integers(1, cfg.vocab_size, (B, T2)),
        "alt_attention_mask": np.ones((B, T2), np.int64),
        "alt_labels": alt_labels,
        "audio_lens": np.full((B,), mel_frames, np.int32),
        "audio_token_len": np.full((B,), n_tok, np.int32),
        "audio_token_start_idx": np.full((B,), 4, np.int32),
        "audio_chunk_batch_idx": np.arange(B, dtype=np.int32),
    }.items()}
    batch["audio_values"] = _tp_mel(B, 10.0, rng, dev)
    return batch


def _tp_requests(cfg, dev):
    """TP_REQ requests of 10 s audio in a prompt of TP_PROMPT tokens, as a
    collated batch (numpy)."""
    rng = np.random.default_rng(TP_SEED + 200)
    return _batch(cfg, _tp_mel(TP_REQ, TP_SECONDS, rng, dev), TP_PROMPT, rng)


def _tp_train(tc, uv, cfg, params, counters, dev, mesh=None):
    """TP_TRAIN_STEPS KL steps (projector + audio LoRA trained, remat,
    vocab_chunk 256, flash in both towers, the recipe's kl_temperature 2),
    each timed between two synchronisations: (losses, grad norms, step ms,
    launches)."""
    from ultravox_torch.training import train_step as ts

    opt = ts.make_optimizer(1e-4, warmup_steps=0, total_steps=100)
    state, template = ts.init_train_state(params, opt, TRAINABLE, device=dev)
    step = ts.make_train_step(
        cfg, tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE, kl_temperature=2.0), opt,
        template, remat=True, attn_impl="flash", vocab_chunk=256, mesh=mesh)
    batches = [_tp_train_batch(cfg, s, dev) for s in range(TP_TRAIN_STEPS)]
    losses, norms, step_ms = [], [], []

    def run():
        nonlocal state
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))

    _, launches = _count_launches(counters, run)
    del state, step
    torch.cuda.empty_cache()
    return losses, norms, step_ms, launches


def _tp_first_logits(cfg, params, dev, mesh=None, cache_dtype=torch.bfloat16):
    """The requests' prefill through a GenerationEngine (fused encoder, #4
    prefill, #8 decode), then one decode step on fixed tokens (not the
    argmax, which near-flat random-weight logits may flip between two sums
    of the same values): (prefill logits, decode-step logits), fp32 on the
    host."""
    from ultravox_torch.inference.engine import GenerationEngine

    eng = GenerationEngine(params, cfg, max_cache_len=1024, encoder_attn_impl="fused",
                           prefill_attn_impl="fused", decode_attn_impl="kernel", mesh=mesh,
                           device=dev, cache_dtype=cache_dtype)
    batch = eng.pad_batch({k: np.asarray(v) for k, v in _tp_requests(cfg, dev).items()})
    tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    with torch.inference_mode():
        cache = eng._ensure_cache(None, tb["input_ids"].shape[0], 1024)
        first, cache, lens = eng._prefill(tb, cache, 0)
        toks = torch.arange(first.shape[0], dtype=torch.int32, device=first.device) + 100
        logits, _, _ = eng._decode(cache, toks, lens)
    out = torch.stack([first[:TP_REQ].float().cpu(), logits[:TP_REQ].float().cpu()])
    del eng, cache
    torch.cuda.empty_cache()
    return out


def _tp_serve(cfg, params, counters, dev, label, kw, mesh=None, leader=True):
    """One ServingEngine (fused encoder, #4 prefill, the decode and block
    kernels) serving the requests, queued before its loop starts: (tokens
    of each request, TTFT ms of each, tok/s, launches, engine stats). A
    mesh's other rank only runs its loop (its tokens from its copies)."""
    from ultravox_torch.inference.serving.engine import ServingEngine

    batch = _tp_requests(cfg, dev)
    eng = ServingEngine(params, cfg, num_slots=TP_REQ, max_seq_len=1024,
                        encoder_attn_impl="fused", prefill_attn_impl="fused",
                        decode_attn_impl="kernel", block_attn_impl="kernel", mesh=mesh,
                        device=dev, **kw)
    out = {"held_gb": _held_bytes(eng.params) / 1e9,
           "vocab_gb": _held_bytes(eng.params, VOCAB_PATHS) / 1e9}

    def run():
        if leader:
            t0 = time.perf_counter()
            res = _serve(eng, [_row(batch, i) for i in range(TP_REQ)], TP_NEW)
            out["wall_s"] = time.perf_counter() - t0
            out["tokens"] = [ids for ids, _, _ in res]
            out["ttft_ms"] = [t * 1e3 for _, _, t in res]
            out["finish"] = [f for _, f, _ in res]
            eng.stop()
        else:
            eng.start()
            eng.stop()  # returns when rank 0's loop has stopped every rank's
            out["tokens"], out["finish"] = [], []
            for r in sorted(eng.mirrored, key=lambda r: r.request_id):
                ids, end = [], None
                while end is None:
                    ev = r.out_queue.get(timeout=60)
                    if ev.token_id is None:
                        end = ev.finish_reason
                    else:
                        ids.append(ev.token_id)
                out["tokens"].append(ids)
                out["finish"].append(end)

    _, launches = _count_launches(counters, run)
    out["launches"] = launches
    out["stats"] = {"dispatches": eng.stat_decode_dispatches, "steps": eng.stat_decode_steps,
                    "chunks": eng.stat_prefill_chunks, "K": eng.decode_block_steps,
                    "spec_dispatches": eng.spec_dispatches}
    if out["finish"] != ["length"] * TP_REQ or any(len(t) != TP_NEW for t in out["tokens"]):
        _fail(f"phase 15 serving {label}: finishes {out['finish']}, "
              f"{[len(t) for t in out['tokens']]} tokens")
    if leader and out.get("wall_s"):
        out["tok_s"] = TP_REQ * TP_NEW / out["wall_s"]
    L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
    enc = {"fused_layer_norm": L_enc * TP_REQ, "ln_qkv_head_fused": L_enc * TP_REQ,
           "attention_headmajor": L_enc * TP_REQ}
    st = out["stats"]
    names = {k: v for k, v in launches.items() if k in counters}
    if "spec" not in label:
        paged = label.startswith("paged")
        _check_serving_launches(
            f"phase 15 {label}", names, counters, enc, st["dispatches"], st["steps"],
            st["chunks"], st["K"], L_dec,
            "paged_decode_attention" if paged else "decode_attention",
            "paged_segment_tail_attention" if paged else "segment_tail_attention")
    else:
        block = ("paged_segment_tail_attention" if label.startswith("paged")
                 else "segment_tail_attention")
        if st["spec_dispatches"] == 0 or names[block] == 0 or any(
                names[k] != v for k, v in enc.items()):
            _fail(f"phase 15 serving {label}: launches {names}, stats {st}")
    del eng
    torch.cuda.empty_cache()
    return out


# the paths of the vocabulary leaves, which tensor splits on the vocabulary
VOCAB_PATHS = r"language_model/(embed_tokens|lm_head/kernel)"


def _held_bytes(tree, paths: str = ".*") -> int:
    """Bytes of the storages that the leaves of ``tree`` whose path matches
    ``paths`` hold, each storage counted once."""
    from ultravox_torch.parallel.sharding import path_items

    seen, total = set(), 0
    for path, t in path_items(tree):
        store = t.untyped_storage()
        if re.fullmatch(paths, path) and store.data_ptr() not in seen:
            seen.add(store.data_ptr())
            total += store.nbytes()
    return total


def _collective_tally(vocab_shape) -> collections.Counter:
    """Count, from here on in this process, the calls to torch.distributed's
    all_reduce, all_gather_into_tensor, reduce_scatter_tensor and broadcast
    (the collectives ultravox_torch issues; broadcast_object_list's inner
    ones are not seen) under "<name> calls", the bytes of each one's buffer
    (all_reduce's and broadcast's tensor, the all-gather's output, the
    reduce-scatter's input) under "<name> bytes", and under "vocab gathers"
    the all-gathers whose output is a whole vocabulary leaf
    (``vocab_shape``, (V, D): how either leaf's gather over ``tensor``
    comes out). Returns the Counter the counts go into; the counts of a
    window are the Counter after it less a copy taken before it."""
    import torch.distributed as dist

    tally = collections.Counter()

    def wrap(name, buffer):
        real = getattr(dist, name)

        def counted(*args, **kwargs):
            t = buffer(*args)
            tally[f"{name} bytes"] += t.numel() * t.element_size()
            tally[f"{name} calls"] += 1
            if name == "all_gather_into_tensor" and tuple(t.shape) == tuple(vocab_shape):
                tally["vocab gathers"] += 1
            return real(*args, **kwargs)

        setattr(dist, name, counted)

    wrap("all_reduce", lambda t, *_: t)
    wrap("all_gather_into_tensor", lambda out, *_: out)
    wrap("reduce_scatter_tensor", lambda out, inp, *_: inp)
    wrap("broadcast", lambda t, *_: t)
    return tally


def _phase15_rank(spec_path: str) -> None:
    """One rank of phase 15, started by _tensor_main_path with torchrun's
    environment and LOCAL_RANK 0 (two ranks share the one card): a gloo
    group opened here (NCCL refuses two ranks on one device; make_mesh
    leaves an open group alone), the mesh data 1 x fsdp 1 x tensor 2, the
    model cut over it, then (a) the train steps, (b) the serving runs and
    the first decode step's logits, the collectives counted throughout
    (``_collective_tally``). With the spec's "baseline" (a checkout's root)
    the rank imports that checkout's ultravox_torch instead of this one's.
    Writes its facts to <out>.<rank> (JSON) and its logits to
    <out>.<rank>.pt."""
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    # the package of this checkout, or of the tree it is compared with
    sys.path.insert(0, spec.get("baseline") or os.path.dirname(os.path.abspath(__file__)))
    from ultravox_torch.models import config as tc
    from ultravox_torch.models import ultravox as uv
    from ultravox_torch.parallel import mesh as pm
    from ultravox_torch.parallel.sharding import path_items, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, dev = int(os.environ["RANK"]), "cuda"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=2, rank=rank)
    pm.initialize_multihost(device=dev)  # the open group is left alone
    mesh = pm.make_mesh(pm.MeshConfig(1, 1, 2, 1))
    counters = _kernel_counters()
    cfg = _tp_config(tc)
    t0 = time.perf_counter()
    whole = _tp_params(tc, uv, cfg, dev)
    whole_bytes = sum(_nbytes(t) for _, t in path_items(whole))
    params = shard_params(whole, mesh, cfg=cfg)
    del whole
    torch.cuda.empty_cache()
    held = sum(t.untyped_storage().nbytes() for _, t in path_items(params))
    out = {"rank": rank, "backend": dist.get_backend(), "mesh": mesh.shape,
           "coords": mesh.coords, "whole_gb": whole_bytes / 1e9, "held_gb": held / 1e9,
           "init_s": time.perf_counter() - t0}
    print(f"phase 15 rank {rank}: mesh {mesh.shape} at {mesh.coords}, backend "
          f"{out['backend']}; holds {held / 1e9:.3f} GB of the {whole_bytes / 1e9:.3f} GB model",
          flush=True)
    tally = _collective_tally((cfg.text_config.vocab_size, cfg.text_config.hidden_size))
    torch.cuda.reset_peak_memory_stats()
    before = collections.Counter(tally)
    losses, norms, step_ms, launches = _tp_train(tc, uv, cfg, params, counters, dev, mesh)
    sent = tally - before
    out["train"] = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
                    "launches": launches,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "collective_mb_per_step": {k[:-6]: v / 1e6 / TP_TRAIN_STEPS
                                               for k, v in sent.items() if k.endswith(" bytes")},
                    "collectives_per_step": {k[:-6]: v / TP_TRAIN_STEPS
                                             for k, v in sent.items() if k.endswith(" calls")},
                    "vocab_gathers": sent["vocab gathers"]}
    out["serving"] = {}
    base = _tp_base(params)
    before = collections.Counter(tally)
    for label, kw in TP_SERVING:
        out["serving"][label] = _tp_serve(cfg, base, counters, dev, label, kw, mesh,
                                          leader=rank == 0)
    logits = _tp_first_logits(cfg, base, dev, mesh)
    out["engines_vocab_gathers"] = (tally - before)["vocab gathers"]
    torch.save(logits, f"{spec['out']}.{rank}.pt")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(f"{spec['out']}.{rank}", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _tp_rank_facts(r: dict) -> dict:
    """What phase 15 holds a rank's layout to, from its facts."""
    slots = r["serving"]["slots"]
    return {"held_gb": r["held_gb"], "engine_gb": slots["held_gb"],
            "engine_vocab_gb": slots["vocab_gb"], "train_peak_gb": r["train"]["peak_memory_gb"],
            "collective_mb_per_step": sum(r["train"]["collective_mb_per_step"].values()),
            "all_gather_mb_per_step": r["train"]["collective_mb_per_step"].get(
                "all_gather_into_tensor", 0.0),
            "vocab_gathers_train": r["train"]["vocab_gathers"],
            "vocab_gathers_engines": r["engines_vocab_gathers"],
            "step_ms": r["train"]["step_ms"]}


def _tensor_main_path(tc, uv, counters, smi, dev, baseline=None):
    """Phase 15: the tensor axis on the one card. Two ranks of this script
    share cuda:0 over a gloo group of their own (each rank's collectives
    carry CUDA tensors through the host), the mesh data 1 x fsdp 1 x tensor
    2 over the model of v0.6_qwen3_32b_tpu.yaml (Qwen3-32B at its published
    widths, 8 of its 64 layers, whisper-large-v3-turbo's encoder, random
    weights from the seed), through the user's entry points:

      (a) TP_TRAIN_STEPS train steps (KL, projector + audio LoRA trained,
          flash in both towers, remat, vocab_chunk 256): the two ranks'
          losses and grad norms bit-equal, each within FLASH_E2E_LOSS_RTOL
          / FLASH_E2E_GRAD_RTOL (bf16) of one process on the same weights
          and batches (this process, after the ranks); #13 launched 2 x 32
          + 3 x 8 times forward and 32 + 8 backward (x BWD_LAUNCHES) a step
          at a rank's local heads (10 of 20 encoder heads, 32 / 4 of 64 / 8
          decoder heads); each rank's held bytes against the whole model,
          peak memory, step ms;
      (b) on the base model (the LoRA leaves dropped, so the encoder's
          q/k/v fuse), ServingEngine(mesh=) slots, paged, and both with
          speculative decoding (the guard off, so #11 / #12 run at T = 9):
          4 requests of 10 s audio x 32 greedy tokens; both ranks' tokens
          identical; launches checked on each rank against its engine's
          counters (#1-#3 32 an admission at (1, 500, 1280) -> (1, 30,
          500, 64) -> (1, 10, 500, 64); #4, #8 / #9, #11 / #12 at 4 local
          KV heads); token agreement with one process's engines (slots,
          paged) and their TTFT and tok/s; the prefill's and the first
          decode step's logits (GenerationEngine(mesh=)) bit-equal on the
          ranks and, against one process's fp32 logits, at most
          TP_LOGITS_FACTOR times one process's own bf16 relative RMS.

    Each rank also reports what it holds and sends: the bytes of its tree
    and of its slots ServingEngine's parameters (the vocabulary leaves
    apart), the train steps' peak memory, the collectives' bytes a step,
    and the all-gathers that made a vocabulary leaf whole, in the steps
    and in the engines: there must be none. With ``baseline`` (the root of
    another checkout, whose kernels this build serves) two ranks of that
    checkout's package run first, and the two layouts are printed side by
    side.

    Returns (metrics, {path: launches})."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    cfg = _tp_config(tc)
    print(f"phase 15: 2 ranks on cuda:0 over gloo, mesh data 1 x fsdp 1 x tensor 2; {smi}",
          flush=True)
    root = tempfile.mkdtemp(prefix="tensor_")
    try:
        base_facts = None
        if baseline is not None:
            os.makedirs(os.path.join(root, "baseline"))
            spec = {"out": os.path.join(root, "baseline", "result.json"), "baseline": baseline}
            base_facts = [_tp_rank_facts(r) for r in _run_ranks(
                spec, os.path.join(root, "baseline"), 2, phase=15, one_card=True)]
        spec = {"out": os.path.join(root, "result.json")}
        t0 = time.perf_counter()
        ranks = _run_ranks(spec, root, 2, phase=15, one_card=True)
        ranks_s = time.perf_counter() - t0
        logits = [torch.load(f"{spec['out']}.{r}.pt") for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    facts = [_tp_rank_facts(r) for r in ranks]
    for rank, f in enumerate(facts):
        print(f"phase 15: rank {rank} holds {f['held_gb']:.3f} GB, its slots ServingEngine "
              f"{f['engine_gb']:.3f} GB ({f['engine_vocab_gb']:.3f} GB of them the embedding "
              f"and the head); train peak {f['train_peak_gb']:.3f} GB; collectives "
              f"{f['collective_mb_per_step']:.3f} MB a step ({f['all_gather_mb_per_step']:.3f} "
              f"MB of all-gathers); whole-vocabulary gathers {f['vocab_gathers_train']} in "
              f"{TP_TRAIN_STEPS} steps, {f['vocab_gathers_engines']} in the engines; {smi}",
              flush=True)
        if base_facts is not None:
            b = base_facts[rank]
            print(f"phase 15: rank {rank}, the baseline against this tree: "
                  + "; ".join(f"{k} {b[k]} / {f[k]}" for k in f) + f"; {smi}", flush=True)
        if f["vocab_gathers_train"] or f["vocab_gathers_engines"]:
            _fail(f"phase 15: rank {rank} gathered a vocabulary leaf whole: {f}")
    r0, r1 = ranks
    if (r0["backend"], r1["backend"]) != ("gloo", "gloo") or [r["coords"]["tensor"]
                                                              for r in ranks] != [0, 1]:
        _fail(f"phase 15: the ranks ran as {[(r['backend'], r['coords']) for r in ranks]}")

    # (a) against one process
    from ultravox_torch.ops.kernels import flash_attention as fl

    L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
    want = {name: 0 for name in r0["train"]["launches"]}
    want["flash_attention"] = TP_TRAIN_STEPS * (2 * L_enc + 3 * L_dec)
    want["flash_attention_bwd"] = TP_TRAIN_STEPS * (L_enc + L_dec) * fl.BWD_LAUNCHES
    for r in ranks:
        if r["train"]["launches"] != want:
            _fail(f"phase 15: rank {r['rank']} train launches {r['train']['launches']}, "
                  f"expected {want}")
    if (r0["train"]["losses"], r0["train"]["grad_norms"]) != (r1["train"]["losses"],
                                                               r1["train"]["grad_norms"]):
        _fail(f"phase 15: the ranks' losses differ: {r0['train']} / {r1['train']}")
    t0 = time.perf_counter()
    whole = _tp_params(tc, uv, cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    ref_losses, ref_norms, ref_ms, _ = _tp_train(tc, uv, cfg, whole, counters, dev)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(r0["train"]["losses"], ref_losses))
    rel_norm = max(abs(a - b) / abs(b) for a, b in zip(r0["train"]["grad_norms"], ref_norms))
    print(f"phase 15 (a): losses {r0['train']['losses']} (both ranks bit-equal) against one "
          f"process's {ref_losses}: largest relative difference {rel_loss:.3g} (tolerance "
          f"{FLASH_E2E_LOSS_RTOL}); grad norms {r0['train']['grad_norms']} against "
          f"{ref_norms}: {rel_norm:.3g} ({FLASH_E2E_GRAD_RTOL}); launches a rank {want}; {smi}",
          flush=True)
    if not rel_loss <= FLASH_E2E_LOSS_RTOL or not rel_norm <= FLASH_E2E_GRAD_RTOL:
        _fail(f"phase 15: tensor 2 against one process: loss {rel_loss}, grad norm {rel_norm}")
    for r in ranks:
        print(f"phase 15 (a): rank {r['rank']} holds {r['held_gb']:.3f} GB of the "
              f"{r['whole_gb']:.3f} GB model ({r['held_gb'] / r['whole_gb']:.3f}); train peak "
              f"memory {r['train']['peak_memory_gb']:.3f} GB (one process "
              f"{ref_peak:.3f} GB); step ms {[round(t, 3) for t in r['train']['step_ms']]} (one "
              f"process {[round(t, 3) for t in ref_ms]}); {smi}", flush=True)

    # (b) serving against one process
    whole = _tp_base(whole)
    ref_logits = _tp_first_logits(cfg, whole, dev)
    f32 = _to_float(whole)
    f32_logits = _tp_first_logits(cfg, f32, dev, cache_dtype=torch.float32)
    del f32
    torch.cuda.empty_cache()
    same_logits = bool(torch.equal(logits[0], logits[1]))
    rms = {}
    for i, name in enumerate(("prefill", "decode_step")):
        rms[name] = {"tensor2_one": _rel_rms(logits[0][i], ref_logits[i]),
                     "tensor2_fp32": _rel_rms(logits[0][i], f32_logits[i]),
                     "one_fp32": _rel_rms(ref_logits[i], f32_logits[i])}
    print(f"phase 15 (b): logits' relative RMS (the prefill's last, the first decode step's): "
          f"tensor 2 against one process {[round(r['tensor2_one'], 5) for r in rms.values()]}; "
          f"against one process in fp32: tensor 2 "
          f"{[round(r['tensor2_fp32'], 5) for r in rms.values()]}, one process in bf16 "
          f"{[round(r['one_fp32'], 5) for r in rms.values()]} (tensor 2 at most "
          f"{TP_LOGITS_FACTOR}x); the ranks' bit-equal {same_logits}", flush=True)
    if not same_logits or any(not r["tensor2_fp32"] <= TP_LOGITS_FACTOR * r["one_fp32"]
                              for r in rms.values()):
        _fail(f"phase 15: logits {rms}, ranks equal {same_logits}")
    serving = {}
    for label, kw in TP_SERVING:
        a, b = r0["serving"][label], r1["serving"][label]
        if a["tokens"] != b["tokens"]:
            _fail(f"phase 15 serving {label}: the ranks' tokens differ")
        row = {"ttft_ms": a["ttft_ms"], "tok_s": a["tok_s"], "launches": a["launches"],
               "stats": a["stats"]}
        agree = None
        if "spec" not in label:
            ref = _tp_serve(cfg, whole, counters, dev, label, kw)
            agree = sum(x == y for p, q in zip(a["tokens"], ref["tokens"]) for x, y in zip(p, q))
            row.update(one_process_ttft_ms=ref["ttft_ms"], one_process_tok_s=ref["tok_s"],
                       agree=agree)
        serving[label] = row
        one = ""
        if agree is not None:
            one = (f"; {agree} of {TP_REQ * TP_NEW} equal to one process's (TTFT ms "
                   f"{[round(t, 3) for t in row['one_process_ttft_ms']]}, "
                   f"{row['one_process_tok_s']:.3f} tok/s)")
        launched = {k: v for k, v in a["launches"].items() if v}
        print(f"phase 15 (b) {label}: both ranks' {TP_REQ} x {TP_NEW} tokens identical; TTFT "
              f"ms {[round(t, 3) for t in a['ttft_ms']]}; {a['tok_s']:.3f} tok/s{one}; stats "
              f"{a['stats']}; launches a rank {launched}; {smi}", flush=True)
    del whole
    torch.cuda.empty_cache()
    metrics = {
        "ranks_s": ranks_s, "held_gb": [r["held_gb"] for r in ranks], "whole_gb": r0["whole_gb"],
        "layout": facts, "baseline_layout": base_facts,
        "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
        "train": {"losses": r0["train"]["losses"], "grad_norms": r0["train"]["grad_norms"],
                  "one_process_losses": ref_losses, "one_process_grad_norms": ref_norms,
                  "max_rel_loss": rel_loss, "max_rel_grad_norm": rel_norm,
                  "step_ms": [r["train"]["step_ms"] for r in ranks],
                  "one_process_step_ms": ref_ms},
        "logits_rel_rms": rms, "serving": serving,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"phase 15: {metrics['phase_s']:.2f} s", flush=True)
    launched = {"train": r0["train"]["launches"]}
    launched.update({label: r0["serving"][label]["launches"] for label, _ in TP_SERVING})
    return metrics, launched


def _phase15_only(tc, uv, dev, baseline=None) -> None:
    """Phase 15 alone, after the build (``--phases 15 [--baseline DIR]``,
    DIR another checkout's root inside this one, as a ``git archive`` of
    the parent into ``scratch_tree/``, whose csrc/ this build serves: its
    build/ directory gets this one's libraries). No result line."""
    import shutil

    from ultravox_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if baseline is not None:
        baseline = os.path.realpath(baseline)
        here = os.path.dirname(os.path.realpath(__file__))
        if os.path.commonpath([baseline, here]) != here or baseline == here:
            _fail(f"phase 15: --baseline {baseline} is not a directory inside {here}; this "
                  f"phase writes the kernels it builds into the baseline's tree")
        shutil.copytree(_build.BUILD_DIR, os.path.join(
            baseline, "ultravox_torch", "ops", "kernels", "build"), dirs_exist_ok=True)
    _tensor_main_path(tc, uv, _kernel_counters(), smi, dev, baseline=baseline)
    print("chip_smoke: phase 15 only, no result", flush=True)


# --------------------------------------------------------------------------
# phase 16: the pipe axis (GPipe over the decoder stack), two ranks
# --------------------------------------------------------------------------

PP_SEED = 16
PP_TRAIN_STEPS = 3
PP_BATCH, PP_MICRO = 8, 4


def _pp_config(tc):
    """The model of v0.6_llama3_70b_pipe_tpu.yaml: Llama-3.3-70B at its
    published widths (8 of its 80 layers), whisper-large-v3-turbo's
    encoder, the 4096-wide projector with ln_mid over stacks of 8 frames."""
    return tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(
            num_mel_bins=128, d_model=1280, num_layers=32, num_heads=20, ffn_dim=5120,
            max_source_positions=1500,
        ),
        text_config=tc.DecoderConfig(
            arch="llama", vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=8, num_heads=64, num_kv_heads=8, head_dim=128, rope_theta=500000.0,
            rope_scaling=(8.0, 1.0, 4.0, 8192), rms_norm_eps=1e-5, tie_word_embeddings=False,
            max_position_embeddings=131072,
        ),
        hidden_size=4096,
        stack_factor=8,
        projector_ln_mid=True,
    )


def _pp_train(tc, cfg, params, counters, dev, mesh=None):
    """The validation step on one batch, then PP_TRAIN_STEPS KL steps of
    PP_BATCH rows (projector + audio LoRA trained, remat, vocab_chunk 256,
    flash in the encoder, the recipe's kl_temperature 2), each timed
    between two synchronisations; with ``mesh`` pipelined in PP_MICRO
    microbatches. The validation runs first, so that it reads the same
    weights as one process does. Returns (losses, grad norms, step ms,
    (nll sum, count), launches)."""
    from ultravox_torch.training import train_step as ts

    pipe = mesh if mesh is not None and mesh.n_stages > 1 else None
    loss_cfg = tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE, kl_temperature=2.0)
    opt = ts.make_optimizer(1e-4, warmup_steps=0, total_steps=100)
    state, template = ts.init_train_state(params, opt, TRAINABLE, device=dev)
    step = ts.make_train_step(cfg, loss_cfg, opt, template, remat=True, attn_impl="flash",
                              vocab_chunk=256, pipe_mesh=pipe, pipe_micro=PP_MICRO, mesh=mesh)
    eval_step = ts.make_eval_step(cfg, loss_cfg, template, vocab_chunk=256, attn_impl="flash",
                                  pipe_mesh=pipe, pipe_micro=PP_MICRO, mesh=mesh)
    batches = [_tp_train_batch(cfg, s, dev, B=PP_BATCH, seed=PP_SEED)
               for s in range(PP_TRAIN_STEPS + 1)]
    losses, norms, step_ms = [], [], []

    def run():
        nonlocal state
        s, c = eval_step(state, batches[-1])
        for b in batches[:-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return float(s), int(c)

    val, launches = _count_launches(counters, run)
    trace = _pp_trace(lambda: step(state, batches[0]))
    del state, step, eval_step
    torch.cuda.empty_cache()
    return losses, norms, step_ms, val, launches, trace


PP_KERNEL_KINDS = (("#13 flash", ("flash_",)), ("products", ("gemm", "nvjet", "cutlass", "xmma")),
                   ("copies", ("Memcpy", "Memset")))


def _pp_trace(fn) -> dict:
    """One more step under torch.profiler (after the counted ones): its
    wall ms, the ms the card ran this process's kernels, and those ms by
    kind (#13, matrix products, copies, the rest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    by = dict.fromkeys([k for k, _ in PP_KERNEL_KINDS] + ["other"], 0.0)
    for e in evs:
        kind = next((k for k, marks in PP_KERNEL_KINDS if any(m in e.key for m in marks)),
                    "other")
        by[kind] += e.self_device_time_total / 1e3
    return {"wall_ms": wall_ms, "busy_ms": sum(by.values()), "by_kind_ms": by}


def _phase16_rank(spec_path: str) -> None:
    """One rank of phase 16, started by _pipe_main_path with torchrun's
    environment and LOCAL_RANK 0 (two ranks share the one card): a gloo
    group opened here (NCCL refuses two ranks on one device), the mesh
    data 1 x fsdp 1 x tensor 1 x pipe 2, the model cut to this stage's
    layers, then the validation batch and the train steps. Writes its facts
    to <out>.<rank> (JSON)."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ultravox_torch.models import config as tc
    from ultravox_torch.models import ultravox as uv
    from ultravox_torch.parallel import mesh as pm
    from ultravox_torch.parallel import pipeline
    from ultravox_torch.parallel.sharding import path_items, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    rank, dev = int(os.environ["RANK"]), "cuda"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=2, rank=rank)
    pm.initialize_multihost(device=dev)  # the open group is left alone
    mesh = pm.make_mesh(pm.MeshConfig(1, 1, 1, 2))
    counters = _kernel_counters()
    cfg = _pp_config(tc)
    t0 = time.perf_counter()
    for turn in range(2):  # one rank at a time holds the whole model on the shared card
        if turn == rank:
            whole = _tp_params(tc, uv, cfg, dev, seed=PP_SEED)
            whole_bytes = sum(_nbytes(t) for _, t in path_items(whole))
            params = shard_params(whole, mesh, cfg=cfg)
            del whole
            torch.cuda.empty_cache()
        dist.barrier()
    held = sum(t.untyped_storage().nbytes() for _, t in path_items(params))
    M = pipeline.default_n_micro(PP_BATCH, 2) if PP_MICRO is None else PP_MICRO
    out = {"rank": rank, "backend": dist.get_backend(), "mesh": mesh.shape,
           "coords": mesh.coords, "stage": mesh.stage, "whole_gb": whole_bytes / 1e9,
           "held_gb": held / 1e9, "init_s": time.perf_counter() - t0, "n_micro": M,
           "schedule_steps": M + mesh.n_stages - 1}
    print(f"phase 16 rank {rank}: mesh {mesh.shape} at {mesh.coords}, backend "
          f"{out['backend']}; stage {mesh.stage} holds {held / 1e9:.3f} GB of the "
          f"{whole_bytes / 1e9:.3f} GB model", flush=True)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms, val, launches, trace = _pp_train(tc, cfg, params, counters, dev,
                                                             mesh)
    out["train"] = {"losses": losses, "grad_norms": norms, "step_ms": step_ms, "val": val,
                    "launches": launches, "trace": trace,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    with open(f"{spec['out']}.{rank}", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _pipe_main_path(tc, uv, counters, smi, dev):
    """Phase 16: the pipe axis on the one card. Two ranks of this script
    share cuda:0 over a gloo group of their own (each hop crosses a pinned
    host buffer), the mesh data 1 x fsdp 1 x tensor 1 x pipe 2 over the
    model of v0.6_llama3_70b_pipe_tpu.yaml (Llama-3.3-70B at its published
    widths, 8 of its 80 layers, 4 a stage; whisper-large-v3-turbo's
    encoder; random weights from the seed), through the user's entry
    points: one validation batch, then PP_TRAIN_STEPS train steps (KL at
    temperature 2, projector + audio LoRA trained, flash in the encoder,
    remat, vocab_chunk 256, B PP_BATCH in PP_MICRO microbatches, so M + P -
    1 = 5 schedule steps). Held: the two ranks' losses, grad norms and
    validation sums equal; each within FLASH_E2E_LOSS_RTOL /
    FLASH_E2E_GRAD_RTOL (bf16) of one process on the same weights and
    batches (this process, after the ranks; its decoder runs #13, the
    stages the plain attention of the JAX package's pipelined layer); #13
    launched 2 x 32 forward (the encoder's forward and its recompute) and
    32 backward (x BWD_LAUNCHES) a step on each rank (every stage runs the
    tower), 32 forward in the validation batch, and no other kernel.
    Printed: the GB each rank holds and its peak against one process's,
    the step ms a rank against one process's, and a fourth step traced on
    each rank and in one process (wall ms, the card's ms on its kernels,
    by kind).

    Returns (metrics, {path: launches})."""
    import shutil
    import tempfile

    from ultravox_torch.ops.kernels import flash_attention as fl

    t_phase = time.perf_counter()
    cfg = _pp_config(tc)
    print(f"phase 16: 2 ranks on cuda:0 over gloo, mesh data 1 x fsdp 1 x tensor 1 x pipe 2; "
          f"{smi}", flush=True)
    root = tempfile.mkdtemp(prefix="pipe_")
    try:
        spec = {"out": os.path.join(root, "result.json")}
        t0 = time.perf_counter()
        ranks = _run_ranks(spec, root, 2, phase=16, one_card=True)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0, r1 = ranks
    if (r0["backend"], r1["backend"]) != ("gloo", "gloo") or [r["stage"] for r in ranks] != [0, 1]:
        _fail(f"phase 16: the ranks ran as {[(r['backend'], r['coords']) for r in ranks]}")
    L_enc = cfg.audio_config.num_layers
    want = {name: 0 for name in r0["train"]["launches"]}
    want["flash_attention"] = PP_TRAIN_STEPS * 2 * L_enc + L_enc
    want["flash_attention_bwd"] = PP_TRAIN_STEPS * L_enc * fl.BWD_LAUNCHES
    for r in ranks:
        if r["train"]["launches"] != want:
            _fail(f"phase 16: rank {r['rank']} launches {r['train']['launches']}, "
                  f"expected {want}")
    keys = ("losses", "grad_norms", "val")
    if [r0["train"][k] for k in keys] != [r1["train"][k] for k in keys]:
        _fail(f"phase 16: the ranks' results differ: {r0['train']} / {r1['train']}")
    whole = _tp_params(tc, uv, cfg, dev, seed=PP_SEED)
    whole_gb = sum(_nbytes(t) for t in _leaves(whole)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    ref_losses, ref_norms, ref_ms, ref_val, _, ref_trace = _pp_train(tc, cfg, whole, counters,
                                                                      dev)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    del whole
    torch.cuda.empty_cache()
    val, ref_v = r0["train"]["val"][0] / r0["train"]["val"][1], ref_val[0] / ref_val[1]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(r0["train"]["losses"] + [val],
                                                        ref_losses + [ref_v]))
    rel_norm = max(abs(a - b) / abs(b) for a, b in zip(r0["train"]["grad_norms"], ref_norms))
    print(f"phase 16: losses {r0['train']['losses']} and validation loss {val} (both ranks "
          f"equal) against one process's {ref_losses} / {ref_v}: largest relative difference "
          f"{rel_loss:.3g} (tolerance {FLASH_E2E_LOSS_RTOL}); grad norms "
          f"{r0['train']['grad_norms']} against {ref_norms}: {rel_norm:.3g} "
          f"({FLASH_E2E_GRAD_RTOL}); validation labels {r0['train']['val'][1]} / "
          f"{ref_val[1]}; {smi}", flush=True)
    if (not rel_loss <= FLASH_E2E_LOSS_RTOL or not rel_norm <= FLASH_E2E_GRAD_RTOL
            or r0["train"]["val"][1] != ref_val[1]):
        _fail(f"phase 16: pipe 2 against one process: loss {rel_loss}, grad norm {rel_norm}")
    print(f"phase 16: {r0['n_micro']} microbatches of {PP_BATCH // r0['n_micro']} rows, "
          f"{r0['schedule_steps']} schedule steps (M + P - 1) a pass; #13 a rank "
          f"{want['flash_attention']} forward, {want['flash_attention_bwd']} backward launches "
          f"({PP_TRAIN_STEPS} steps and a validation batch)", flush=True)
    for r in ranks:
        print(f"phase 16: rank {r['rank']} (stage {r['stage']}) holds {r['held_gb']:.3f} GB of "
              f"the {r['whole_gb']:.3f} GB model ({r['held_gb'] / r['whole_gb']:.3f}); peak "
              f"memory {r['train']['peak_memory_gb']:.3f} GB (one process {ref_peak:.3f} GB, "
              f"holding {whole_gb:.3f}); step ms {[round(t, 3) for t in r['train']['step_ms']]} "
              f"(one process {[round(t, 3) for t in ref_ms]}); {smi}", flush=True)
    for label, tr in [(f"rank {r['rank']}", r["train"]["trace"]) for r in ranks] + [
            ("one process", ref_trace)]:
        kinds = ", ".join(f"{k} {v:.3f}" for k, v in tr["by_kind_ms"].items())
        print(f"phase 16 traced step, {label}: {tr['wall_ms']:.3f} ms, the card ran its kernels "
              f"{tr['busy_ms']:.3f} ms ({kinds}); {smi}", flush=True)
    metrics = {
        "ranks_s": ranks_s, "held_gb": [r["held_gb"] for r in ranks], "whole_gb": r0["whole_gb"],
        "peak_memory_gb": [r["train"]["peak_memory_gb"] for r in ranks],
        "traced_step": [r["train"]["trace"] for r in ranks], "one_process_traced_step": ref_trace,
        "one_process_peak_memory_gb": ref_peak, "n_micro": r0["n_micro"],
        "schedule_steps": r0["schedule_steps"],
        "train": {"losses": r0["train"]["losses"], "grad_norms": r0["train"]["grad_norms"],
                  "val_loss": val, "one_process_losses": ref_losses,
                  "one_process_grad_norms": ref_norms, "one_process_val_loss": ref_v,
                  "max_rel_loss": rel_loss, "max_rel_grad_norm": rel_norm,
                  "step_ms": [r["train"]["step_ms"] for r in ranks],
                  "one_process_step_ms": ref_ms},
        "launches_a_rank": want,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"phase 16: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, {"train": r0["train"]["launches"]}


def _phase16_only(tc, uv, dev) -> None:
    """Phase 16 alone, after the build (``--phases 16``). No result line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _pipe_main_path(tc, uv, _kernel_counters(), smi, dev)
    print("chip_smoke: phase 16 only, no result", flush=True)


# --------------------------------------------------------------------------
# phase 17: run_serving_eval and the host tools at the flagship width
# --------------------------------------------------------------------------

SE_SAMPLES, SE_BATCH, SE_TOKENS = 16, 8, 32
# the up-projected projector on the card against the same call on the CPU:
# both fit in fp64, then one fp32 product of 1536 terms each side
UPPROJECT_TOL = 1e-5


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _serving_eval_main_path(tc, uv, counters, smi, dev):
    """Phase 17: the flagship (phase 4's weights, remade from the seed)
    through run_serving_eval and the host tools:

      (b) save_pretrained(include_code=True) writes it (bf16, with
          _write_flagship_tokenizer's tokenizer): the five hub files and
          config.json's auto_map must be there (loading them needs
          ``transformers``, which the CPU tests hold; this machine has none);
      (a) run_serving_eval.start_server serves that directory on the card
          (its CLI's 16 slots and 4096 positions, every attention flag
          "auto") until /health says ok, then eval_datasets drives it
          through OpenAIInference over HTTP: SE_SAMPLES synthetic-asr
          samples in batches of SE_BATCH, SE_TOKENS tokens each; the score
          must be finite, and the kernels' launches in that run must match
          the engine's own counters (_check_serving_launches; the client
          sends one request at a time, so the decode may run in blocks
          alone). Samples/s;
      (c) average_checkpoints of that directory and a second flagship tree
          (seed 1): sampled tensors bit-equal to the bf16 of their fp64
          mean, the average loaded back by load_ultravox_checkpoint (its
          embedding bit-equal to the file's) and run by
          GenerationEngine.generate;
      (d) upproject_adapter of the flagship projector from its 2048-wide
          embedding to a random 4096-wide one over the 128256 ids, on the
          card, against the same call on the CPU (both fit in fp64): the
          largest difference of the new linear_2 within UPPROJECT_TOL of
          its largest value; the seconds of each.

    Returns (metrics, {name: launches of (a)})."""
    import shutil
    import tempfile
    import urllib.request

    from ultravox_torch.evaluation.eval import EvalConfig, eval_datasets
    from ultravox_torch.hub import AUTO_MAP, HUB_CODE_FILES
    from ultravox_torch.inference import run_serving_eval as rse
    from ultravox_torch.inference.engine import GenerationEngine
    from ultravox_torch.inference.ultravox_infer import load_ultravox_checkpoint
    from ultravox_torch.models.weights import load_safetensors_dir
    from ultravox_torch.ops.mel import log_mel_spectrogram
    from ultravox_torch.tools.infer_api import OpenAIInference
    from ultravox_torch.tools.model_averaging import average_checkpoints
    from ultravox_torch.tools.projector_tools import upproject_adapter
    from ultravox_torch.tools.publish import save_pretrained

    t_phase = time.perf_counter()
    cfg = _flagship_config(tc)
    metrics = {}
    root = tempfile.mkdtemp(prefix="serving_eval_")
    try:
        # (b) published with the hub code
        params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                                torch.bfloat16, dev)
        ckpt = os.path.join(root, "seed0")
        t0 = time.perf_counter()
        save_pretrained(params, cfg, ckpt, include_code=True, dtype=None)
        write_s = time.perf_counter() - t0
        _write_flagship_tokenizer(ckpt)
        with open(os.path.join(ckpt, "config.json")) as f:
            auto_map = json.load(f).get("auto_map")
        missing = [n for n in HUB_CODE_FILES if not os.path.isfile(os.path.join(ckpt, n))]
        if missing or auto_map != AUTO_MAP:
            _fail(f"phase 17 (b): hub files missing {missing}, auto_map {auto_map}")
        print(f"phase 17 (b): save_pretrained(include_code=True) wrote the flagship in "
              f"{write_s:.3f} s with {len(HUB_CODE_FILES)} hub files and auto_map {auto_map}",
              flush=True)

        # (a) run_serving_eval's server, driven over HTTP
        server, engine, port = rse.start_server(ckpt, num_slots=16, max_seq_len=4096)
        try:
            rse.wait_healthy(port)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as r:
                health = json.load(r)
            flags = engine.resolved_flags
            paged = flags["cache_mode"] == "paged"
            if (flags["decode_attn_impl"], flags["prefill_attn_impl"],
                    flags["encoder_attn_impl"]) != ("kernel", "fused", "fused") or (
                    not paged and flags["block_attn_impl"] != "kernel"):
                _fail(f"phase 17 (a): the server resolved {flags}")
            stats0 = (engine.stat_decode_dispatches, engine.stat_decode_steps,
                      engine.stat_prefill_chunks)
            client = OpenAIInference(f"http://127.0.0.1:{port}", timeout=600)
            config = EvalConfig(eval_sets=["synthetic-asr"], num_samples=SE_SAMPLES,
                                batch_size=SE_BATCH, max_tokens=SE_TOKENS,
                                output_dir=os.path.join(root, "eval"))
            t0 = time.perf_counter()
            scores, launches = _count_launches(counters, lambda: eval_datasets(client, config))
            eval_s = time.perf_counter() - t0
            disp, steps, chunks = (engine.stat_decode_dispatches - stats0[0],
                                   engine.stat_decode_steps - stats0[1],
                                   engine.stat_prefill_chunks - stats0[2])
            K = engine.decode_block_steps
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
        del engine
        torch.cuda.empty_cache()
        got = scores.get("synthetic-asr", {})
        if (health.get("status") != "ok" or got.get("num_samples") != SE_SAMPLES
                or not np.isfinite(got.get("score", float("nan")))):
            _fail(f"phase 17 (a): /health {health}, scores {scores}")
        L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
        enc = {"fused_layer_norm": L_enc * SE_SAMPLES, "ln_qkv_head_fused": L_enc * SE_SAMPLES,
               "attention_headmajor": L_enc * SE_SAMPLES}
        block = flags["block_attn_impl"] == "kernel"
        singles, blocks = _check_serving_launches(
            "phase 17 (a)", {k: v for k, v in launches.items() if k in counters}, counters,
            enc, disp, steps, chunks, K, L_dec,
            "paged_decode_attention" if paged else "decode_attention",
            ("paged_segment_tail_attention" if paged else "segment_tail_attention")
            if block else None, mixed=False)
        metrics["serving_eval"] = {"samples_per_s": SE_SAMPLES / eval_s, "seconds": eval_s,
                                   "score": got["score"], "metric": got["metric"],
                                   "health": health, "flags": flags, "singles": singles,
                                   "blocks": blocks, "chunks": chunks}
        print(f"phase 17 (a): run_serving_eval's server ({flags}), /health {health}: "
              f"{SE_SAMPLES} synthetic-asr samples in batches of {SE_BATCH} x {SE_TOKENS} "
              f"tokens over HTTP in {eval_s:.3f} s, {SE_SAMPLES / eval_s:.3f} samples/s; "
              f"{got['metric']} {got['score']}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; {smi}", flush=True)

        # (c) two flagship trees averaged
        proj, embed = params["projector"], params["language_model"]["embed_tokens"]
        other = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                               torch.bfloat16, dev)
        ckpt1 = os.path.join(root, "seed1")
        save_pretrained(other, cfg, ckpt1, dtype=None)
        del other
        avg_dir = os.path.join(root, "average")
        t0 = time.perf_counter()
        average_checkpoints([ckpt, ckpt1], avg_dir)
        avg_s = time.perf_counter() - t0
        a, b, m = (load_safetensors_dir(d) for d in (ckpt, ckpt1, avg_dir))
        keys = ["language_model.model.embed_tokens.weight",
                f"language_model.model.layers.{L_dec // 2}.self_attn.q_proj.weight",
                f"language_model.model.layers.{L_dec - 1}.mlp.down_proj.weight",
                f"audio_tower.layers.{L_enc // 2}.fc1.weight",
                "multi_modal_projector.linear_1.weight"]
        for k in keys:
            want = ((a[k].double() + b[k].double()) / 2).to(torch.bfloat16)
            if m[k].dtype != torch.bfloat16 or not torch.equal(m[k].view(torch.int16),
                                                               want.view(torch.int16)):
                _fail(f"phase 17 (c): {k} is not the bf16 of the fp64 mean")
        _, avg_params, _ = load_ultravox_checkpoint(avg_dir, torch.bfloat16)
        if not torch.equal(avg_params["language_model"]["embed_tokens"].cpu(), m[keys[0]]):
            _fail("phase 17 (c): the loaded average's embedding is not the file's")
        del a, b, m
        gen_engine = GenerationEngine(avg_params, cfg, max_cache_len=1024)
        rng = np.random.default_rng(SEED + 17)
        mel = log_mel_spectrogram(torch.from_numpy(_audio(2, 5.0, rng)).to(dev))
        ids = gen_engine.generate(_batch(cfg, mel, 64, rng), max_new_tokens=8).token_ids
        if [len(r) for r in ids] != [8, 8] or any(not 0 <= t < cfg.vocab_size
                                                  for r in ids for t in r):
            _fail(f"phase 17 (c): generate on the average gave {ids}")
        del gen_engine, avg_params
        torch.cuda.empty_cache()
        metrics["average"] = {"seconds": avg_s, "keys_checked": len(keys)}
        print(f"phase 17 (c): average_checkpoints of seeds 0 and 1 in {avg_s:.3f} s; "
              f"{len(keys)} sampled tensors bit-equal to the bf16 of the fp64 mean; loaded "
              f"and generated {ids[0]}; {smi}", flush=True)

        # (d) the projector up-projected to a 4096-wide embedding
        big = (torch.randn((cfg.vocab_size, 4096), generator=torch.Generator(
            device=dev).manual_seed(SEED + 4), device=dev) * 0.02).to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = upproject_adapter(proj, embed, big)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = upproject_adapter(_tree_to(proj, "cpu"), embed.cpu(), big.cpu())
        cpu_s = time.perf_counter() - t0
        want = host["linear_2"]["kernel"]
        err = float((card["linear_2"]["kernel"].cpu() - want).abs().max() / want.abs().max())
        if tuple(want.shape) != (proj["linear_2"]["kernel"].shape[0], 4096) or not (
                err <= UPPROJECT_TOL):
            _fail(f"phase 17 (d): linear_2 {tuple(want.shape)}, card against CPU {err}")
        metrics["upproject"] = {"card_s": card_s, "cpu_s": cpu_s, "rel_err": err}
        print(f"phase 17 (d): upproject_adapter of the projector to a 4096-wide embedding "
              f"over {cfg.vocab_size} ids: card {card_s:.3f} s, CPU {cpu_s:.3f} s, linear_2 "
              f"{tuple(want.shape)} within {err:.3g} of the CPU's largest value (tolerance "
              f"{UPPROJECT_TOL}); {smi}", flush=True)
        del params, proj, embed, big, card, host
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {metrics['phase_s']:.2f} s", flush=True)
    return metrics, launches


def _phase17_only(tc, uv, dev) -> None:
    """Phase 17 alone, after the build (``--phases 17``). No result line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _serving_eval_main_path(tc, uv, _kernel_counters(), smi, dev)
    print("chip_smoke: phase 17 only, no result", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase14-rank":
        _phase14_rank(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--phase15-rank":
        _phase15_rank(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--phase16-rank":
        _phase16_rank(sys.argv[2])
    else:
        main()
