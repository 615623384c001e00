"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the port's CUDA kernels from ``localai_tpu_torch/csrc`` (one
     nvcc per source, sm_90a, all five started together) and the C trie
     walk of ``localai_tpu_torch/native`` (cc), and print the build time
     and a ptxas summary per source;
  3. kernels, each against its plain PyTorch version on the same inputs:
     - K1 paged decode attention at the serving shapes (S=8, Hq=32, Hkv=8,
       hd=128, bt=64, ragged positions up to 4096, shuffled block tables)
       on bf16 and f32 pools and on scaled int8 and int4 pools built by
       the port's quantizers, plus sliding-window (across split
       boundaries, at the plan's, the finest and a single split) and
       hd=64 cases; each recorded with its split plan; times for the
       kernel at the plan and as a single walk (``single_walk_ms``), the
       plain version and one library call
       (scaled_dot_product_attention over K/V gathered and dequantized
       beforehand — a yardstick only), and the byte bound;
     - K2 contiguous decode attention at the same shape over a
       [8, 8, 4096, 128] cache in bf16, f32 and scaled int8, plus window
       (across split edges, at the plan's, the finest and a single
       split), hd=64 (a context of 1000 rows, no multiple of the kernel's
       tile) and f32-q int8 cases, each recorded with its split plan;
       times as for K1, the single walk included (library: SDPA over the
       cache, masked to each slot's rows), byte bound;
     - K3 prefill attention at Hq=32, Hkv=8, hd=128 for T = 512, 2048 and
       4096 (length = T; bf16 also at 1024) and T=2048 with 1001 real rows, in bf16 and f32,
       a window case, hd=64 GQA-1 cases, and the bf16 kernel at both
       block sizes (the plan's rows a block recorded); every row compared;
       times
       for the kernel, the plain version and SDPA (is_causal, or the same
       boolean mask), and the operation bound over the kept pairs;
     - K4 w8_matmul and K5 w4_matmul at Llama-3-8B's decode shapes (M=8
       rows against each projection and the lm_head), the tied lm_head
       orientation of debug:1b ([128256, 2048] table, K4 only) and the
       edges M=1 and M=256, in bf16 and f32; times for the kernel, the
       plain version and one library call (torch.matmul against the
       weight dequantized beforehand — it streams twice the int8 bytes),
       and the byte bound; the same at M=40 (a verify window of 8 slots x
       (gamma 4 + 1) rows); then, untimed, every M edge of the bf16
       tensor-core tile (1, 8, 16, 17, 64, 256) and the verify windows'
       5, 10, 15 and 72 rows at w_gate and wk/wv, K5 with groups of 256,
       each record with its split plan, so every split count the plan
       gives these shapes runs; K2 and K3 at the widths of the spec
       parity phase's draft runner;
  4. parity: the port's runner on the card and on the CPU give identical
     greedy tokens (debug:small, float32) on the paged layout with float,
     int8 and int4 weights and pool, and on the contiguous layout with a
     float and an int8 cache; ``embed`` vectors agree within 1e-4 of the
     vector's largest magnitude; then speculative decoding: the greedy
     streams of a spec engine equal the spec-off streams on the card and
     on the CPU (paged f32, int8 and int4 weights and pools with the
     n-gram drafter, the w8/w4 kernel 7L+1 times a verify window; a
     contiguous cache with a draft model whose steps and resyncs launch
     K2 and K3), with windows and accepted draft tokens in each mode;
     then ``step_frozen_n``, the dispatch of constrained decoding: on a
     paged pool and a contiguous cache in f32 and int8, slots behind
     band bias rows frozen one, two and three at a time give the CPU's
     rows token for token, K1/K2 launch exactly L x decode_steps, and a
     frozen slot's rewritten K/V row is unchanged by the next step;
  5. serving: the port's HTTP server serves debug:llama3-8b (Llama-3-8B
     widths and depth, random weights from a seed) four times — bf16
     paged, bf16 contiguous (``kv_paged: false``), int8 weights and pool,
     int4 weights and pool — answering concurrent chat completions, one
     streaming. The decode kernel of the layout launches exactly once per
     layer per decode step (the other decode kernel never), the prefill
     kernel once per layer per fresh contiguous prefill, and the w8/w4
     kernel on every projection of every layer plus the lm_head. The
     paged bf16 server (``embeddings: true``) then answers embeddings and
     rerank requests while it decodes a chat: the prefill kernel launches
     exactly once per layer per embedded input. A fifth server,
     ``llama3-8b-bf16-spec``, has no ``spec`` key, so speculative decoding
     is on as a user gets it; it answers the same five requests and a
     sixth whose logit bias makes its stream cycle: verify windows run
     and accept draft tokens, K1 launches once per layer per plain decode
     step between windows, and the count of its five texts equal to the
     spec-off bf16 server's is printed (bf16 near-ties may break apart;
     equality is asserted in f32 by the parity phase). A sixth server,
     ``llama3-8b-bf16-tools`` (bf16 paged, speculation on by default),
     answers eight concurrent greedy chats with tools (auto, required, a
     named function), bounded json_schema, json_object and one plain
     chat, then a streamed tools chat: answers that end with stop are
     accepted by their DFAs, tool calls name offered functions with
     arguments their schemas accept, frozen dispatches run, no verify
     window runs beside a constrained slot, K1 launches L per decode
     step, and the C trie walk (``native/fsm_walk.c``) served every mask
     row, equal to the numpy walk's. It prints tokens/s, the step wall of
     a frozen dispatch against a pipelined one, the host ms per
     constrained token, the ms to build a new state's mask row over a
     128256-piece synthetic vocabulary (C and numpy) and the row cache's
     bytes. A seventh serve, ``llama3-8b-bf16-templates`` beside
     ``llama3-8b-bf16-chat-template``, is loaded from YAML files (Go
     templates in block scalars; a Jinja ``chat_template``) by the port's
     own YAML reader and template engine, with neither PyYAML nor Jinja2
     imported: eight concurrent greedy chats (system + user, multi-turn,
     a tools chat through the ``functions`` template, one on the
     ``chat_template`` model, one streamed), then a two-prompt ``n: 2``
     completion and an edit. Every request reaches the scheduler with the
     token ids of its golden prompt (pinned here, held equal to the JAX
     package's rendering by a CPU test), each ``n: 2`` pair of greedy
     choices is identical, K1 launches L per decode step of both engines;
     it prints tokens/s, the streamed TTFT, prompt tokens per request and
     host ms to render each kind of template, first and cached. Before the
     serves, a templated parity phase loads debug:small in f32 from a YAML
     with a chat_message template, paged and contiguous: the card's prompt
     ids and greedy tokens equal the CPU's (K1; K2 and K3);
  6. a real checkpoint: a debug:small-width f32 checkpoint with Llama-3's
     128256-id vocabulary and this script's tokenizer.json (a byte-level
     BPE with Llama-3's split pattern, ``ignore_merges`` and Llama-3's 256
     special tokens, its merges learned by a stdlib trainer over
     ``TOKENIZER_CORPUS``) gives the card's prompt ids and greedy tokens
     equal to the CPU's on both layouts, the ids the golden ones (held to
     ``tokenizers`` by tests/test_torch_tokenizer.py); the real entry
     point in subprocesses (``tokenize`` gives the golden ids, ``version``,
     ``run`` with ``LOCALAI_KV_DTYPE=int8`` serves from an int8 pool on the
     card, ``run --mesh data=2`` exits 2 naming ROADMAP item 19 part 2);
     then the
     eighth serve,
     ``llama3-8b-bf16-checkpoint``: a bf16 checkpoint directory with
     Meta-Llama-3-8B-Instruct's config.json (full widths, the depth of
     ``SMOKE_LAYERS``, seeded random weights) is served through ``cli.main.build_server``
     with ``LOCALAI_MODELS_PATH``, ``LOCALAI_API_KEYS`` and
     ``LOCALAI_ADDRESS``: 401 without or with a wrong key, eight
     concurrent greedy chats with their golden prompt ids (the streamed
     one's deltas joining to its text), <|eot_id|> ending a biased chat,
     a required tool call inside its DFA over the 128256 ids, K1 32 times
     a decode step; it prints the checkpoint's write and load seconds,
     tokens/s, the streamed TTFT, host ms to encode each golden prompt
     (first and cached), to build the byte table over 128256 ids, and the
     trie's size;
  7. Mixtral-class sparse MoE: K4's expert grid (``w8_matmul_experts``,
     one launch per expert projection) at Mixtral-8x7B's widths (8
     experts, D 4096, F 14336) at M = 8 and 40 in bf16 against its plain
     version, timed beside cuBLAS on the stack dequantized beforehand and
     the byte bound (one layer's gate + up + down against 1.409 GB), and
     untimed at small widths in f32 and bf16 up to a 300-row chunk;
     ``moe_parity``: a debug:small-width MoE (4 experts, top 2, int8
     weights, f32) gives prefill logits within 1e-4 and greedy tokens
     equal to the CPU's on a paged pool and a contiguous cache, the
     expert grid launching 3 times a layer a step; ``gguf_convert``: a
     GGUF at Mixtral-8x7B's widths with 2 layers in llama.cpp's Q4_K_M
     mix, written here, converted by ``util convert`` in a subprocess and
     served from a one-line YAML with ``quantization: int8`` (quantized
     as it loads) through ``cli.main.build_server``, two greedy chats;
     then the ninth serve, ``mixtral-8x7b-int8``: Mixtral-8x7B-Instruct's
     published widths and depth with int8 weights drawn in quantized form
     on the card (46.7 GB), the default paged config with speculation,
     five greedy chats through the HTTP server, K1 32 a decode step and
     K4 225 a decode step, verify window and prefill chunk exactly, peak
     memory under 80 GB; it prints the weight bytes, tokens/s, the
     streamed TTFT and the launch counts;
  8. image and video chat (LLaVA), run after the templated parity phase
     (media, vision parity, group-1 kernels) and before the Mixtral serve
     (the LLaVA serve): ``media`` decodes the committed fixtures of
     ``tests/data/media`` (a 640x480 4:2:0 JPEG, an 800x600 progressive
     JPEG, a 512x512 RGBA PNG, a 4-frame GIF; written by
     ``scripts/make_media_fixtures.py``) with the port's stdlib + numpy
     readers and holds each to its committed PIL decode (PNG and GIF byte
     for byte, JPEG within max 2 / mean 0.25), printing host ms to decode
     and to preprocess; ``vision_parity``: a float32 LLaVA of debug:small's
     widths with the ``vit`` tower, card against CPU — tower embeddings
     within 1e-4, greedy tokens of an image + video chat through the
     scheduler equal on a paged engine with speculation and on a
     contiguous one, K1 = L per paged step, K3 = L per contiguous
     prefill, K2 = L per contiguous step exactly; the group-1 cases: K1,
     K2 and K3 at Llama-2-7B's shape (Hq = Hkv = 32, hd 128, 8 slots,
     bf16; K3 at T = 640, 2048 and a 2048 bucket of 640 rows) against
     their plain versions, timed beside SDPA with their plans; then the
     tenth serve, ``llava-1.5-7b-bf16``: LLaVA-1.5-7B's published widths
     and depth (llava-hf/llava-1.5-7b-hf's config.json) with bf16 weights
     drawn on the card, the default paged config with speculation, five
     greedy 32-token chats over HTTP (the JPEG streamed, the progressive
     JPEG, the PNG, the GIF as a video_url, a text-only one), then the
     same weights on a contiguous engine with two image chats; it prints
     the weight bytes (text, tower, projector), peak memory, tokens/s,
     the streamed TTFT and its parts (fetch + decode, preprocess, tower
     encode and multimodal prefill on CUDA events) and the launches, K1 =
     32 per paged step, K3 = 32 per contiguous prefill and K2 = 32 per
     contiguous step asserted exactly;
  9. the rest of the text families, which launch none of K1–K5 (each
     phase asserts it): ``recurrent_parity`` (after the vision phases):
     Mamba and RWKV at small depth in float32 from checkpoint
     directories written here (with a byte-level BPE tokenizer.json),
     loaded by ``resolve_mamba`` / ``resolve_rwkv`` on the card and on
     the CPU — prefill logits within 1e-4 of the largest, the decode
     step against the prefill's next position, 32 greedy tokens equal;
     after the Mixtral serve, ``mamba-2.8b-bf16`` (state-spaces/
     mamba-2.8b-hf's widths and depth, 2.77 B parameters) and
     ``rwkv-4-7b-bf16`` (RWKV/rwkv-4-7b-pile's, 7.39 B), bf16 weights
     drawn on the card, each served as ``backend: mamba | rwkv`` over HTTP
     with five greedy 32-token chats (one streamed), printing the weight
     bytes, peak memory, tokens/s, the streamed TTFT, prefill ms at 128,
     512 and 2048 tokens (CUDA events) and a decode step's ms, launches
     and device idle share (torch.profiler); then ``encoders``:
     ``/v1/rerank`` on a cross-encoder at ms-marco-MiniLM-L-6-v2's widths
     (a query against 32 documents, then four more requests) and
     ``/v1/embeddings`` on a sentence encoder at bge-large-en-v1.5's (64
     inputs of 10–400 tokens), float32 checkpoints with a 30522-id
     WordPiece tokenizer.json written here, scores and vectors within
     1e-4 of the CPU's; ms a request, inputs/s and the forward on CUDA
     events;
 10. the engine's last three load refusals, lifted: ``w8a8`` (after the
     K4/K5 cases) holds the int8_w8a8 product (``quant.int8_matmul``:
     torch._int_mm, rows padded past its 16-row floor) equal to the exact
     float64 product at Llama-3-8B's projections and lm_head at M = 8, 40
     and 256 and the edges 1, 16 and 17, and a tied table, timing the
     whole w8a8 matmul, the product, K4 on the same weight and a bf16
     torch.matmul; after the parity phase, card = CPU greedy tokens
     (debug:small, float32) for int8_w8a8 weights over an int8 pool
     (paged: K1 launches, K4 none), for self-extend (ga_n 4, ga_w 32) on
     the contiguous layout past a trained context cut to 64, float32 and
     int8 caches (no kernel launches), and for the disk prompt cache: a
     cold serve and a warm one from its directory on the paged and
     contiguous layouts, float32 and int8, on both devices, and the
     card's directory read by the CPU; after the speculating bf16 serve,
     three serves of debug:llama3-8b over HTTP, five chats each (one
     streamed): ``llama3-8b-w8a8`` (int8_w8a8 weights, an int8 pool, the
     default paged layout with speculation: K1 32 a plain step, K4 0,
     weight bytes and peak memory), ``llama3-8b-bf16-selfextend``
     (grp_attn_n 2, grp_attn_w 2048, context 16384: the manager's
     contiguous layout without speculation, no kernel launch, then a
     12000-token prompt past the trained 8192, its TTFT and peak memory)
     and ``llama3-8b-bf16-promptcache`` (the default paged layout with
     speculation and ``prompt_cache_path``: a chat behind a ~2000-token
     system prompt stores one entry, the server restarts on the directory
     and answers from it; the cold and warm TTFT, the entry's bytes, the
     writer's store ms, the lookup and load ms, and how many of the five
     texts equal the speculating cache-less server's).
 11. image generation (after the audio group), which launches none of
     K1–K5 (asserted): ``image_parity`` holds the card to the CPU in
     float32 at debug widths on the SD-1 layout (1x1 proj_in, one
     encoder, a ControlNet) and the SDXL layout (1 and 2 transformer
     blocks by level, heads per level, two encoders, text_time): UNet
     eps, VAE decode and encode, CLIP states and pooled output within
     1e-4 of the largest output, 4-step generations (euler_a, dpmpp_2m)
     with latents within 1e-4 and pixels within 1; then
     ``sdxl-base-1.0-bf16``: SDXL base 1.0's published configs (3.47 B
     params) drawn in bf16 on the card, written as a diffusers directory
     with CLIP-format tokenizers, served from a ``backend: diffusers``
     YAML: two 1024x1024 images of 20 steps (``b64_json``, then ``url``
     fetched back), PNGs decoded at the requested size, latents finite,
     one bf16 UNet step within 2e-2 of float32 and one CFG step
     profiled; then SD-1.5's widths served twice, with a rank-8 kohya
     LoRA at 0.8 (99 merges asserted) and with a ControlNet of
     sd-controlnet-canny's config given an edge image in ``file``: two
     512x512 images each. It prints load and write seconds, bytes, peak
     memory, text-encode / UNet-step / VAE-decode ms (CUDA events),
     seconds an image, images a minute, the profiled step's launches
     and idle share, and its own seconds. Then FLUX: ``flux_parity``
     holds the card to the CPU at ``debug:flux-tiny``'s widths in
     float32 (T5 with and without a mask, the MMDiT's velocity within
     1e-4; a 3-step generation and a 0.5-strength img2img, latents within
     1e-4, pixels within 1); then ``flux.1-dev-f32``: FLUX.1-dev's
     published transformer/, text_encoder_2/ (T5-v1.1-XXL's encoder),
     vae/ and scheduler/ configs with CLIP-L (16.87 B params), seeded
     weights drawn on the card entry by entry and streamed to disk in
     bf16 (33.7 GB, T5 in two shards; the VAE with quant convs, which the
     published one lacks and the reference's loader needs), a Unigram
     tokenizer_2 of 32000 pieces and 100 extra ids with a ``Precompiled``
     charsmap from the port's writers, served from a ``backend:
     diffusers`` YAML in float32 (TF32 off): a 1024x1024 image of 4 steps
     and a 512x512 img2img from it; load seconds, peak memory, T5 /
     MMDiT-step / VAE ms, seconds an image, one full-width double and
     single block card = CPU within 1e-4 at 1152 tokens;
 12. ``qwen2.5-7b-bf16`` (after the checkpoint serve): Qwen2.5-7B's
     published config (a GQA group of 7; the depth of ``SMOKE_LAYERS``)
     served from a checkpoint with one API key, K1 once per layer a
     decode step; then
     ``phase_telemetry``, ``phase_observatory`` and ``phase_self_healing``
     on the same server: a ``decode.nan`` fault fails one of four chats
     and quarantines its slot while the other three texts stay the
     unarmed ones; an ``engine.drain`` hang past a 2 s stall deadline
     rebuilds the engine (the next chat's text unchanged, the pool on new
     storage, 0 KV-sweep violations; the rebuild's and probe's time and
     the peak memory across it printed); a 16-line batch uploaded through
     ``/v1/files`` runs on the background lane beside two streamed chats,
     each line's text its interactive chat's (its wall, lines/s and the
     chats' TTFT printed).
 13. the tuning table, the vector store and the gallery:
     ``autotune`` (after the K1 cases) runs ``tools.autotune``'s sweep at
     its llama3-8b preset (hd 128, 8 kv heads, group 4, 4 slots, ctx 512)
     over bf16, int8 and int4 pools at blocks 16/32/64/128, K1 and its
     plain version captured in CUDA graphs whose replays are timed on
     CUDA events, the fastest K1 point of each key installed (the
     default block's where the two are within their runs' spread), each
     kernel point held to its plain one (the K1
     tolerances); ``gallery_serve`` (after the checkpoint serve, whose
     Llama-3-8B checkpoint it keeps) serves a gallery index (an anchor
     and ``!!merge <<:``), a definition YAML and the checkpoint's files
     with their sha256 from a stdlib HTTP server in this process,
     installs through ``/models/galleries``, ``/models/available``,
     ``/models/apply`` and ``/models/jobs/{uuid}`` (a progress between 0
     and 100 % seen), then, with ``LOCALAI_TUNE_CACHE`` at a table whose
     ``hd128_kv8_bfloat16_tp1`` entry sets ``block_tokens`` 32, streams a
     greedy chat on the installed name: one tuning-table hit in
     ``/metrics``, the runner at bt 32, K1 L per decode step and K2–K5
     none, the ids equal to the same checkpoint's served by path with
     ``LOCALAI_KV_BLOCK_TOKENS=32``; ``/models/delete/{name}`` takes it
     out of ``/v1/models``; K1 at bt 32 held to its plain version and
     timed. ``stores`` puts 262144 keys of width 1024 (bge-large's) in a
     store on the card and 1024 more over ``/stores/set``, then 64
     ``/stores/find`` at topk 10 held to a float64 numpy top-k (the same
     rows in the same order, one query on tied keys lower row first,
     similarities within 1e-5); it prints the rebuild time, find p50/p99
     and the store's bytes on the card. ``kv_tier`` holds the host KV
     tier's pool round trip byte for byte (bf16, float32, int8, int4
     pools at Llama-3-8B's block shape) and serves debug:llama3-8b at full
     width and depth with ``LOCALAI_KV_TIER_MB`` unset and at 1024: a
     prefix evicted by two others reloads 15+ of its 16 blocks from
     pinned host memory, the texts equal the tier-off serve's, K1
     launches L a plain step; it prints spill and reload ms and GB/s and
     the reloaded TTFT against the cold one. ``fleet`` serves an 8-layer
     Llama-3-8B-width checkpoint through in-process fleets (``run
     --fleet-backend inprocess``): prefix affinity, a disaggregated
     1100-token prefill, a live migration, a failover with respawn (the
     killed replica's memory freed at its stop), the fleet flight view
     and a stitched trace, then the autoscaler's scale-out and drain with
     every request answered; texts equal a single engine's, K1 launches
     L per decode step summed over every replica engine, nothing is left
     on the card after each fleet, the peak stays under 75 GB.
     ``http_surfaces`` serves debug:llama3-8b at full width and depth
     and GETs every web UI page, ``/swagger`` and its document (with and
     without ``Accept: text/html``), streams the chat page's own request
     (greedy text, ``first_sse_write`` on its trace), creates and deletes
     an assistant and its file, then streams the same chat through the
     port's federation router over two front doors of the engine (peer
     token checked), stops one for a failover and health sweeps; K1
     launches L a decode step on both paths, nothing is left on the card.
     ``worker_tier`` serves debug:llama3-8b at full width and depth in a
     worker process (``backend: worker``) beside the same model in
     process: equal streamed text, an Embedding and TokenizeString over
     the model's own client equal to the engine's, the worker's own
     launch report (K1 = L x its decode steps, K3 = L x its Embedding
     calls), a respawn after an orderly stop and after SIGKILL with the
     dead process's card memory back; then a fleet of three worker
     processes on the card (``SMOKE_LAYERS["fleet"]`` layers, spawned
     unpinned with the warning) with equal routed texts, a prefix handed
     across processes and a failover after SIGKILL; then a remote worker
     (the ``worker`` subcommand) registered through ``POST
     /federated/register`` (a wrong token is a 401), served, evicted when
     killed and rejoined when it is back on its port; no worker process
     and at most 0.25 GB are left behind.
 14. tensor parallelism (``tensor_parallel``, after the worker tier): an
     NCCL group of one runs each collective of the reductions once;
     float32 debug:small at ``model=2`` (leader and spawned follower both
     on the card, collectives over gloo on CUDA tensors) gives one card's
     greedy streams byte for byte; then ``llama3-8b-bf16-tp2``
     (Llama-3-8B's full width and depth, seeded bf16 weights drawn shard
     by shard, bf16 paged at bt 64, 4 slots) is served through
     ``build_server(["run", "--mesh", "model=2"])``: three streamed
     chats and an embedding request, K1 = 32 x decode steps and K3 = 32 x
     its prefills on each rank (the follower's from its stop report), the
     follower's token digest the leader's, half the weights a rank, the
     card's memory back after shutdown; a prefill's logits within
     ``TP_LOGITS_TOL`` of one card's of the same seed (greedy agreement
     printed); it prints the reduction mode, the step wall, the
     collectives' ms a step and K1/K3 timed at a rank's shape.
The line before last is the card's nvidia-smi name and power limit, the
line before it the kernels' JSON record; the last line is the result.
``--profile`` adds a decode-step breakdown (torch.profiler) at the
serving shape after each serving phase.
Exits non-zero without a result when no CUDA device is visible.
"""

from __future__ import annotations

import base64
import concurrent.futures
import dataclasses
import functools
import gc
import json
import os
import re
import math
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
# float32: absolute; bfloat16: per slot (per row for the matmuls),
# relative to that slot's largest output (the output's bf16 rounding is at
# most 2**-8 of it), so a long-context slot, whose outputs are small, is
# held as tightly as a short one
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
L2_FLUSH_BYTES = 128 << 20          # > the 50 MB L2: every timed launch
                                    # finds K/V cold, as a decode layer does
L_8B = 32
# rows of a verify window's matmuls: 8 slots x (gamma 4 + 1)
SPEC_M = 8 * (4 + 1)
# Llama-3-8B decode matmuls: (K, N) of each projection and how many of it
# one layer runs, then the untied lm_head once per step
SHAPES_8B = {"wq/wo": ((4096, 4096), 2), "wk/wv": ((4096, 1024), 2),
             "w_gate/w_up": ((4096, 14336), 2), "w_down": ((14336, 4096), 1),
             "lm_head": ((4096, 128256), 0)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3,
            spin_cycles: int = 0) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, timed with CUDA events. ``spin_cycles`` > 0 spins the card
    that long between the flush and the start event, so that the host's
    enqueueing of ``fn`` is not counted (scripts/k1_timing.py reads both;
    the smoke's own figures take 0)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


def _bound(nbytes: int, flops: int, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


SMOKE_POSITIONS = (4095, 3001, 2048, 2047, 1000, 640, 64, 63)


def k1_inputs(dtype, *, S=8, Hq=32, Hkv=8, hd=128, bt=64, MB=64,
              positions=SMOKE_POSITIONS, pool="", seed=0):
    """Seeded K1 inputs on the card: (q, k, v, tables, pos, scales, ref_kv)
    over a pool of ``dtype`` (pool "") or a scaled int8/int4 pool built by
    the port's quantizers (``dtype`` is then q's); ``scales`` is () or
    (k_scale, v_scale), ``ref_kv`` the pool as the plain version takes
    it."""
    from localai_tpu_torch.models import quant as tq

    g = torch.Generator(device="cuda").manual_seed(seed)
    N = S * MB + 1
    dev = "cuda"
    q = torch.randn((S, Hq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((N, Hkv, bt, hd), generator=g, device=dev)
    v = torch.randn((N, Hkv, bt, hd), generator=g, device=dev)
    # shuffled physical blocks: block 0 (trash) never mapped
    tables = (torch.randperm(N - 1, generator=g, device=dev) + 1).to(
        torch.int32).reshape(S, MB)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    if pool:
        quantize = (tq.quantize_lastdim4 if pool == "int4"
                    else tq.quantize_lastdim)
        k, ks = quantize(k)
        v, vs = quantize(v)
        scales = (ks, vs)
        ref_kv = (k, v)
    else:
        k, v = k.to(dtype), v.to(dtype)
        scales = ()
        ref_kv = (k.float(), v.float())
    return q, k, v, tables, pos, scales, ref_kv


def kernel_case(name, dtype, *, S=8, Hq=32, Hkv=8, hd=128, bt=64, MB=64,
                positions=SMOKE_POSITIONS, window=None, pool="", seed=0,
                split_blocks=None, timed=False):
    """K1 on a pool of ``dtype`` (pool "") or a scaled int8/int4 pool
    (``dtype`` is then q's), split by the wrapper's plan or by
    ``split_blocks``; held against the plain version."""
    from localai_tpu_torch.engine.kvcache import _gather_dequant
    from localai_tpu_torch.ops.attention import (
        gather_blocks,
        paged_decode_attention,
        paged_decode_attention_ref,
        paged_split_plan,
    )

    q, k, v, tables, pos, scales, ref_kv = k1_inputs(
        dtype, S=S, Hq=Hq, Hkv=Hkv, hd=hd, bt=bt, MB=MB, positions=positions,
        pool=pool, seed=seed)
    dev = "cuda"
    if split_blocks is None:
        bps, splits = paged_split_plan(
            S, Hkv, MB, torch.cuda.get_device_properties(0)
            .multi_processor_count, pool)
    else:
        bps, splits = split_blocks, -(-MB // split_blocks)
    out = paged_decode_attention(q, k, v, tables, pos, *scales,
                                 sliding_window=window,
                                 split_blocks=split_blocks)
    torch.cuda.synchronize()
    ref = paged_decode_attention_ref(q.float(), *ref_kv, tables, pos, *scales,
                                     sliding_window=window)
    slot_err = (out.float() - ref).abs().flatten(1).amax(1)
    if dtype == torch.bfloat16:
        slot_tol = TOL[dtype] * ref.abs().flatten(1).amax(1)
    else:
        slot_tol = torch.full_like(slot_err, TOL[dtype])
    err = slot_err.max().item()
    ok = bool((slot_err <= slot_tol).all())
    rec = {"case": name, "dtype": str(dtype).replace("torch.", ""),
           "pool": pool or str(dtype).replace("torch.", ""),
           "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd, "bt": bt, "MB": MB,
           "window": window, "blocks_per_split": bps, "splits": splits,
           "max_abs_err": err, "slot_err": slot_err.tolist(),
           "slot_tol": slot_tol.tolist()}
    if timed:
        # bytes each call must move: the live K/V rows of every slot (from
        # the window's first block to the one holding pos) with their
        # scales, q, out, the tables and positions; operations: 2 products
        # of 2 flops
        elem = q.element_size()
        row = {"int8": hd + 4, "int4": hd // 2 + 4}.get(pool, hd * elem)
        live = 0
        for p in positions:
            nb = min(p // bt + 1, MB)
            lo = max((p - window + 1) // bt, 0) if window else 0
            live += (nb - lo) * bt
        nbytes = (2 * live * Hkv * row + 2 * S * Hq * hd * elem
                  + S * MB * 4 + S * 4)
        flops = 4 * live * Hq * hd
        if pool:
            int4 = pool == "int4"
            keys = _gather_dequant(k, scales[0], tables, dtype, int4)
            values = _gather_dequant(v, scales[1], tables, dtype, int4)
        else:
            keys = gather_blocks(k, tables)
            values = gather_blocks(v, tables)
        idx = torch.arange(MB * bt, device=dev)
        keep = (idx[None, :] <= pos[:, None].long())
        if window:
            keep &= idx[None, :] > pos[:, None].long() - window
        q4 = q[:, :, None, :]
        mask = keep[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:
            sdpa(q4, keys, values, attn_mask=mask, enable_gqa=True)
            kv_lib, gqa = (keys, values), {"enable_gqa": True}
        except TypeError:  # torch < 2.5: heads expanded beforehand
            kv_lib = (keys.repeat_interleave(Hq // Hkv, dim=1),
                      values.repeat_interleave(Hq // Hkv, dim=1))
            gqa = {}

        def library():
            return sdpa(q4, *kv_lib, attn_mask=mask, **gqa)

        def kernel(sb=split_blocks):
            return paged_decode_attention(q, k, v, tables, pos, *scales,
                                          sliding_window=window,
                                          split_blocks=sb)

        # the plan's split and the single walk (one split of MB blocks, the
        # design before the split)
        rec.update(ms=time_ms(kernel), single_walk_ms=time_ms(
            lambda: kernel(MB)))
        rec.update(
            plain_ms=time_ms(lambda: paged_decode_attention_ref(
                q, k, v, tables, pos, *scales, sliding_window=window)),
            library_ms=time_ms(library), **_bound(nbytes, flops, dtype))
    print("kernel case", json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"kernel case {name}: per-slot errors "
                             f"{slot_err.tolist()} exceed "
                             f"{slot_tol.tolist()}")
    return rec


def phase_kernel() -> dict:
    """K1 cases; returns the timed ones by pool."""
    cases = {
        "bf16": kernel_case("main-bf16", torch.bfloat16, timed=True),
        "f32": kernel_case("main-f32", torch.float32, timed=True),
        "int8": kernel_case("main-int8", torch.bfloat16, pool="int8",
                            timed=True, seed=4),
        "int4": kernel_case("main-int4", torch.bfloat16, pool="int4",
                            timed=True, seed=5),
    }
    kernel_case("window-bf16", torch.bfloat16, window=700, seed=1)
    # a window of 700 starts inside a split and crosses split boundaries:
    # the finest split, 2-block splits on an f32 pool, and the single walk
    kernel_case("window-bf16-split1", torch.bfloat16, window=700, seed=1,
                split_blocks=1)
    kernel_case("window-f32-split2", torch.float32, window=700, seed=9,
                split_blocks=2)
    kernel_case("window-int4-single", torch.bfloat16, pool="int4",
                window=700, seed=6, split_blocks=64)
    kernel_case("hd64-bf16", torch.bfloat16, Hq=16, Hkv=4, hd=64, seed=2)
    kernel_case("hd64-f32-g8", torch.float32, Hq=32, Hkv=4, hd=64, seed=3)
    for pool in ("int8", "int4"):
        kernel_case(f"window-{pool}", torch.bfloat16, pool=pool, window=700,
                    seed=6)
        kernel_case(f"main-{pool}-f32q", torch.float32, pool=pool, seed=7)
        kernel_case(f"hd64-{pool}", torch.bfloat16, pool=pool, Hq=16, Hkv=4,
                    hd=64, seed=8)
    return cases


def _check_rows(name, out, ref, dtype) -> tuple[float, bool]:
    """(max abs error, within TOL): float32 absolute, bfloat16 per row of
    the first dim relative to that row's largest output."""
    row_err = (out.float() - ref).abs().flatten(1).amax(1)
    if dtype == torch.bfloat16:
        row_tol = TOL[dtype] * ref.abs().flatten(1).amax(1)
    else:
        row_tol = torch.full_like(row_err, TOL[dtype])
    ok = bool((row_err <= row_tol).all())
    if not ok:
        print(f"kernel case {name}: row errors {row_err.tolist()} exceed "
              f"{row_tol.tolist()}", flush=True)
    return row_err.max().item(), ok


def k2_inputs(dtype, *, kv="", S=8, Hq=32, Hkv=8, hd=128, C=4096,
              positions=SMOKE_POSITIONS, seed=0):
    """Seeded K2 inputs on the card: (q, k, v, pos, scales, ref_kv) over a
    contiguous cache of ``dtype`` (kv "") or scaled int8 built by the
    port's quantizer (``dtype`` is then q's); ``scales`` is () or
    (k_scale, v_scale), ``ref_kv`` the cache as the plain version takes
    it."""
    from localai_tpu_torch.models import quant as tq

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((S, Hq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((S, Hkv, C, hd), generator=g, device=dev)
    v = torch.randn((S, Hkv, C, hd), generator=g, device=dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    if kv:
        k, ks = tq.quantize_lastdim(k)
        v, vs = tq.quantize_lastdim(v)
        return q, k, v, pos, (ks, vs), (k, v)
    k, v = k.to(dtype), v.to(dtype)
    return q, k, v, pos, (), (k.float(), v.float())


def decode_case(name, dtype, *, kv="", S=8, Hq=32, Hkv=8, hd=128, C=4096,
                positions=SMOKE_POSITIONS, window=None, seed=0,
                split_tiles=None, timed=False):
    """K2 over a contiguous [S, Hkv, C, hd] cache in ``dtype`` (kv "") or
    scaled int8 (kv "int8"; ``dtype`` is then q's), split by the wrapper's
    plan or by ``split_tiles``."""
    from localai_tpu_torch.ops.attention import (
        DECODE_TILE,
        decode_attention,
        decode_attention_ref,
        decode_split_plan,
    )

    q, k, v, pos, scales, ref_kv = k2_inputs(
        dtype, kv=kv, S=S, Hq=Hq, Hkv=Hkv, hd=hd, C=C, positions=positions,
        seed=seed)
    dev = "cuda"
    ntiles = -(-C // DECODE_TILE)
    if split_tiles is None:
        tps, splits = decode_split_plan(
            S, Hkv, C, torch.cuda.get_device_properties(0)
            .multi_processor_count, kv)
    else:
        tps, splits = split_tiles, -(-ntiles // split_tiles)
    out = decode_attention(q, k, v, pos, *scales, sliding_window=window,
                           split_tiles=split_tiles)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q.float(), *ref_kv, pos, *scales,
                               sliding_window=window)
    err, ok = _check_rows(name, out, ref, dtype)
    rec = {"case": name, "kernel": "decode_attention",
           "dtype": str(dtype).replace("torch.", ""),
           "kv": kv or str(dtype).replace("torch.", ""), "S": S, "Hq": Hq,
           "Hkv": Hkv, "hd": hd, "C": C, "window": window,
           "tiles_per_split": tps, "splits": splits, "max_abs_err": err}
    del ref
    if timed:
        # bytes each call must move: every slot's live rows (from the
        # window's first row to pos) of K and V with their scales, q, out
        # and positions; operations: 2 products of 2 flops
        elem = q.element_size()
        row = hd + 4 if kv else hd * elem
        live = sum(p + 1 - (max(p - window + 1, 0) if window else 0)
                   for p in positions)
        nbytes = 2 * live * Hkv * row + 2 * S * Hq * hd * elem + S * 4
        if kv:  # the library reads a cache dequantized beforehand
            keys = (k.to(dtype) * scales[0][..., None].to(dtype))
            values = (v.to(dtype) * scales[1][..., None].to(dtype))
        else:
            keys, values = k, v
        idx = torch.arange(C, device=dev)
        keep = idx[None, :] <= pos[:, None].long()
        if window:
            keep &= idx[None, :] > pos[:, None].long() - window
        mask = keep[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def kernel(st=split_tiles):
            return decode_attention(q, k, v, pos, *scales,
                                    sliding_window=window, split_tiles=st)

        # the plan's split and the single walk (one split of every tile,
        # the design before the split)
        rec.update(
            ms=time_ms(kernel), single_walk_ms=time_ms(
                lambda: kernel(ntiles)),
            plain_ms=time_ms(lambda: decode_attention_ref(
                q, k, v, pos, *scales, sliding_window=window), iters=10),
            library_ms=time_ms(lambda: sdpa(q4, keys, values, attn_mask=mask,
                                            enable_gqa=True)),
            **_bound(nbytes, 4 * live * Hq * hd, dtype))
        del keys, values
    print("kernel case", json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"kernel case {name} exceeds its tolerance")
    return rec


def prefill_case(name, dtype, T, *, length=None, window=None, Hq=32, Hkv=8,
                 hd=128, seed=0, block_rows=None, timed=True):
    """K3 for one T-token sequence (q [T, Hq, hd], head-major k/v), every
    row compared, ``length`` real rows (default T); a bf16 case takes the
    wrapper's rows a CUDA block or ``block_rows``."""
    from localai_tpu_torch.ops.attention import (
        prefill_attention,
        prefill_attention_ref,
        prefill_block_rows,
    )

    length = T if length is None else length
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = [torch.randn(shp, generator=g, device="cuda").to(dtype)
               for shp in ((T, Hq, hd), (Hkv, T, hd), (Hkv, T, hd))]
    out = prefill_attention(q, k, v, length, sliding_window=window,
                            block_rows=block_rows)
    torch.cuda.synchronize()
    ref = prefill_attention_ref(q.float(), k.float(), v.float(), length,
                                sliding_window=window)
    err, ok = _check_rows(name, out, ref, dtype)
    del ref
    rec = {"case": name, "kernel": "prefill_attention",
           "dtype": str(dtype).replace("torch.", ""), "T": T,
           "length": length, "window": window, "Hq": Hq, "Hkv": Hkv,
           "hd": hd, "max_abs_err": err}
    if dtype == torch.bfloat16:
        rec["block_rows"] = block_rows or prefill_block_rows(
            T, Hq, Hkv, torch.cuda.get_device_properties(0)
            .multi_processor_count)
    if timed:
        # operations over the (row, key) pairs the mask keeps: row t takes
        # keys <= t below length and inside the window; 2 products of
        # 2 flops each, per query head
        t = torch.arange(T, device="cuda")
        keep = (t[None, :] <= t[:, None]) & (t[None, :] < length)
        if window:
            keep &= t[None, :] > t[:, None] - window
        pairs = int(keep.sum())
        # bytes: q read and out written, k and v read
        nbytes = 2 * (T * Hq + Hkv * T) * hd * q.element_size()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4 = q.transpose(0, 1)[None]
        k4, v4 = k[None], v[None]
        if length == T and not window:
            def library():
                return sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
        else:
            mask = keep[None, None]

            def library():
                return sdpa(q4, k4, v4, attn_mask=mask, enable_gqa=True)
        rec.update(
            ms=time_ms(lambda: prefill_attention(
                q, k, v, length, sliding_window=window,
                block_rows=block_rows), iters=10),
            plain_ms=time_ms(lambda: prefill_attention_ref(
                q, k, v, length, sliding_window=window), iters=3, warmup=1),
            library_ms=time_ms(library, iters=10),
            pairs=pairs, **_bound(nbytes, 4 * pairs * Hq * hd, dtype))
        del keep
    print("kernel case", json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"kernel case {name} exceeds its tolerance")
    return rec


def phase_attention() -> dict:
    """K2 and K3 cases; returns the timed main records by name."""
    main = {
        "k2-bf16": decode_case("k2-bf16", torch.bfloat16, timed=True),
        "k2-f32": decode_case("k2-f32", torch.float32, timed=True, seed=1),
        "k2-int8": decode_case("k2-int8", torch.bfloat16, kv="int8",
                               timed=True, seed=2),
    }
    decode_case("k2-window-bf16", torch.bfloat16, window=700, seed=3)
    decode_case("k2-window-int8", torch.bfloat16, kv="int8", window=700,
                seed=4)
    # a window of 700 starts inside a split and crosses split edges: the
    # finest split, 2-tile splits on an f32 cache, and the single walk
    decode_case("k2-window-bf16-split1", torch.bfloat16, window=700, seed=7,
                split_tiles=1)
    decode_case("k2-window-f32-split2", torch.float32, window=700, seed=8,
                split_tiles=2)
    decode_case("k2-window-int8-single", torch.bfloat16, kv="int8",
                window=700, seed=9, split_tiles=64)
    decode_case("k2-hd64-f32", torch.float32, Hq=16, Hkv=4, hd=64, C=1000,
                positions=(999, 0, 63, 64, 500, 511, 512, 900), seed=5)
    decode_case("k2-int8-f32q", torch.float32, kv="int8", seed=6)
    seed = 20
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for T in (512, 2048, 4096):
            seed += 1
            main[f"k3-T{T}-{tag}"] = prefill_case(f"k3-T{T}-{tag}", dtype, T,
                                                  seed=seed)
        main[f"k3-T2048-len1001-{tag}"] = prefill_case(
            f"k3-T2048-len1001-{tag}", dtype, 2048, length=1001,
            seed=seed + 1)
    main["k3-window-bf16"] = prefill_case("k3-window-bf16", torch.bfloat16,
                                          2048, window=700, seed=30)
    main["k3-T1024-bf16"] = prefill_case("k3-T1024-bf16", torch.bfloat16,
                                         1024, seed=42)
    prefill_case("k3-hd64-g1-f32", torch.float32, 300, length=290, Hq=8,
                 Hkv=8, hd=64, seed=31, timed=False)
    # the speculative parity phase's draft runner (debug:small widths:
    # Hq=8, Hkv=4, hd=32, a 256-row f32 cache): each draft step runs K2,
    # each draft admit and resync K3
    decode_case("k2-draft-f32", torch.float32, S=4, Hq=8, Hkv=4, hd=32,
                C=256, positions=(255, 40, 17, 0), seed=40)
    prefill_case("k3-draft-f32", torch.float32, 64, length=37, Hq=8, Hkv=4,
                 hd=32, seed=41, timed=False)
    # the bf16 kernel at the block size the plan does not pick for these
    # lengths, and at hd=64 with a GQA group of 1 on both sizes
    prefill_case("k3-T4096-rows64-bf16", torch.bfloat16, 4096, seed=32,
                 block_rows=64, timed=False)
    prefill_case("k3-T512-rows128-bf16", torch.bfloat16, 512, seed=33,
                 block_rows=128, timed=False)
    for rows in (64, 128):
        prefill_case(f"k3-hd64-g1-rows{rows}-bf16", torch.bfloat16, 300,
                     length=290, window=120, Hq=8, Hkv=8, hd=64,
                     seed=34 + rows, block_rows=rows, timed=False)
    return main


def qmm_case(kind, dtype, M, K, N, *, transpose=False, seed=0,
             timed=True, group=128) -> dict:
    """K4 (kind "w8") or K5 ("w4", in groups of ``group`` rows) on x
    [M, K] against a weight [K, N] (``transpose``: a [N, K] table, K4
    only) quantized from a seeded normal draw by the port's own
    quantizers; a bf16 case records the tile's split plan."""
    from localai_tpu_torch.models import quant as tq
    from localai_tpu_torch.ops import qmatmul as tqm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((N, K) if transpose else (K, N), generator=g,
                    device="cuda") * 0.02
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    if kind == "w8":
        qt = tq.quantize_tensor(w, 1 if transpose else 0)

        def kernel():
            return tqm.w8_matmul(x, qt.q, qt.scale, transpose_w=transpose)

        def plain(xx):
            return tqm.w8_matmul_ref(xx, qt.q, qt.scale, transpose)

        wbytes = K * N + 4 * N
    else:
        qt = tq.quantize_tensor4(w, 0, group=group)

        def kernel():
            return tqm.w4_matmul(x, qt.q, qt.scale)

        def plain(xx):
            return tqm.w4_matmul_ref(xx, qt.q, qt.scale)

        wbytes = K * N // 2 + qt.scale.numel() * 4
    del w
    out = kernel()
    torch.cuda.synchronize()
    ref = plain(x.float())
    err = (out.float() - ref).abs()
    if dtype == torch.bfloat16:
        tol = TOL[dtype] * ref.abs().amax(1, keepdim=True)
        ok = bool((err <= tol).all())
    else:
        ok = float(err.max()) <= TOL[dtype] * float(ref.abs().max())
    name = "w8_matmul" if kind == "w8" else "w4_matmul"
    rec = {"case": f"{name}{'-T' if transpose else ''}",
           "dtype": str(dtype).replace("torch.", ""), "M": M, "K": K,
           "N": N, "transpose_w": transpose, "group": qt.group,
           "max_abs_err": float(err.max()),
           "max_ref": float(ref.abs().max())}
    if dtype == torch.bfloat16:
        rec["plan"] = tqm.qmm_split_plan(
            M, K, N, qt.group if kind == "w4" else tqm.QMM_BK,
            torch.cuda.get_device_properties(0).multi_processor_count, kind)
    del ref, err
    if timed:
        elem = x.element_size()
        nbytes = wbytes + M * K * elem + M * N * elem
        w_lib = tq.dequantize_tensor(qt, dtype)  # beforehand: a yardstick
        if transpose:
            w_lib = w_lib.T
        rec.update(ms=time_ms(kernel),
                   plain_ms=time_ms(lambda: plain(x), iters=5, warmup=1),
                   library_ms=time_ms(lambda: torch.matmul(x, w_lib)),
                   **_bound(nbytes, 2 * M * K * N, dtype))
        del w_lib
        if kind == "w8":
            rec["int8pack_ms"] = _int8pack_ms(x, qt, transpose)
    print("kernel case", json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"kernel case {rec['case']} {rec['dtype']} "
                             f"M={M} K={K} N={N}: error {rec['max_abs_err']}")
    return rec


def _int8pack_ms(x, qt, transpose):
    """torch._weight_int8pack_mm (x @ w.T * scale with an int8 [N, K]
    weight) where this torch has it for CUDA; else the reason it has not."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return "torch has no _weight_int8pack_mm"
    w_nk = (qt.q if transpose else qt.q.T).contiguous()
    scale = qt.scale.to(x.dtype)
    try:
        fn(x, w_nk, scale)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return f"no CUDA _weight_int8pack_mm: {str(e).splitlines()[0][:120]}"
    return time_ms(lambda: fn(x, w_nk, scale))


def phase_qmatmul() -> dict:
    """K4/K5 cases; returns the bf16 M=8 8B records by kind and shape, and
    the bf16 M=40 ones (a verify window of 8 slots x (gamma 4 + 1) rows)
    under "<kind>-m40"."""
    main: dict = {"w8": {}, "w4": {}, "w8-m40": {}, "w4-m40": {}}
    seed = 10
    for kind in ("w8", "w4"):
        for dtype in (torch.bfloat16, torch.float32):
            for label, ((K, N), _) in SHAPES_8B.items():
                seed += 1
                rec = qmm_case(kind, dtype, 8, K, N, seed=seed)
                if dtype == torch.bfloat16:
                    main[kind][label] = rec
        for label, ((K, N), _) in SHAPES_8B.items():
            seed += 1
            main[f"{kind}-m40"][label] = qmm_case(kind, torch.bfloat16,
                                                  SPEC_M, K, N, seed=seed)
            for M in (1, 256):
                seed += 1
                qmm_case(kind, dtype, M, 4096, 4096, seed=seed)
    for dtype in (torch.bfloat16, torch.float32):
        seed += 1
        main["w8"]["tied-lm_head-1b" if dtype == torch.bfloat16
                   else "tied-f32"] = qmm_case(
            "w8", dtype, 8, 2048, 128256, transpose=True, seed=seed)
    # the bf16 tile's M edges (n8 tiles of 1, 2 and 4 per CUDA block, a
    # ragged 17) on the widest and the narrowest projection, and K5's
    # other gated group size: untimed, each against its plain version
    # ... and the verify windows' M = slots x (gamma + 1) for 1-3 slots
    # and gamma 4 (5, 10, 15: no multiple of 8) and 8 slots at gamma 1
    # and 8 (16, 72)
    splits = set()
    for kind in ("w8", "w4"):
        for (K, N) in ((4096, 14336), (4096, 1024)):
            for M in (1, 8, 16, 17, 64, 256, 5, 10, 15, 72):
                seed += 1
                splits.add(qmm_case(kind, torch.bfloat16, M, K, N, seed=seed,
                                    timed=False)["plan"][1])
    for M in (8, 256):
        seed += 1
        splits.add(qmm_case("w4", torch.bfloat16, M, 4096, 14336, seed=seed,
                            timed=False, group=256)["plan"][1])
    splits |= {r["plan"][1] for kind in ("w8", "w4")
               for r in main[kind].values() if "plan" in r}
    print(f"qmm split counts run: {sorted(splits)}", flush=True)
    for kind in ("w8", "w4"):
        count = {s: (c * L_8B if c else 1) for s, (_, c) in SHAPES_8B.items()}
        for M, key in ((8, kind), (SPEC_M, f"{kind}-m40")):
            step = {f: sum(main[key][s][f] * n for s, n in count.items())
                    for f in ("ms", "bound_ms", "library_ms")}
            what = "decode-step" if M == 8 else "verify-window"
            print(f"{kind} {what} matmuls at 8B (bf16, M={M}; 7 "
                  f"projections x {L_8B} layers + lm_head, from the cases "
                  "above): " + json.dumps(step), flush=True)
    return main


def _to(params, dev):
    """A parameter tree (tensors and QuantizedTensors in dicts and lists)
    on ``dev``."""
    if isinstance(params, dict):
        return {k: _to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, dev) for v in params]
    return params.to(dev)


def phase_parity() -> dict:
    """cuda/cpu greedy parity on both KV layouts, and cuda/cpu embed
    parity; returns the kernels' launches in the card's runs by mode."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.quant import quantize_params
    from localai_tpu_torch.models.registry import resolve_model
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )
    from localai_tpu_torch.ops.qmatmul import w4_matmul, w8_matmul

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention,
                "w8_matmul": w8_matmul, "w4_matmul": w4_matmul}
    model = resolve_model("debug:small", dtype="float32", device="cpu")
    prompts = [list(b"The paged kernel walks each block table"), list(b"hi")]
    embed_prompts = [list(b"embed me"), list(range(3, 203))]
    launches = {}
    # (layout, weights, KV storage): paged float, int8 and int4 weights
    # and pools; contiguous float and an int8 cache under float weights
    for paged, weights, kv in ((True, "", "float32"), (True, "int8", "int8"),
                               (True, "int4", "int4"),
                               (False, "", "float32"), (False, "", "int8")):
        mode = f"{'paged' if paged else 'contiguous'}-{kv}"
        params = (quantize_params(model.params, weights, device="cpu")
                  if weights else model.params)
        seqs, vecs = {}, {}
        for dev in ("cuda", "cpu"):
            r = ModelRunner(model.cfg, _to(params, dev), num_slots=4,
                            max_ctx=256, kv_dtype=kv, kv_block_tokens=16,
                            prefill_chunk=32, paged=paged, device=dev)
            for w in wrappers.values():
                w.launches = 0
            out = []
            slots = []
            for p in prompts:
                s = r.acquire_slot()
                out.append([r.admit(s, p, temperature=0.0)])
                slots.append(s)
            for _ in range(16):
                toks = r.step()
                for o, s in zip(out, slots):
                    o.append(int(toks[s]))
            seqs[dev] = out
            counts = {n: w.launches for n, w in wrappers.items()}
            if mode == "contiguous-float32":
                vecs[dev] = [r.embed(p) for p in embed_prompts]
            print(f"parity {mode} {dev} (decode "
                  f"{r.paged_attn_impl or r.attn_impl}, prefill "
                  f"{r.attn_impl}): {out} launches {json.dumps(counts)}",
                  flush=True)
            if dev == "cuda":
                need = ["paged_decode_attention" if paged
                        else "decode_attention"]
                if not paged:
                    need.append("prefill_attention")
                need += {"int8": ["w8_matmul"],
                         "int4": ["w4_matmul"]}.get(weights, [])
                for n in need:
                    if counts[n] <= 0:
                        raise AssertionError(f"parity {mode}: no {n} launch")
                launches[mode] = counts
            del r
        if seqs["cuda"] != seqs["cpu"]:
            raise AssertionError(
                f"greedy tokens differ between cuda and cpu ({mode})")
        for a, b in zip(vecs.get("cuda", ()), vecs.get("cpu", ())):
            err = float(abs(a - b).max())
            tol = 1e-4 * float(abs(b).max())
            print(f"parity embed: max abs diff {err} (tolerance {tol})",
                  flush=True)
            if not err <= tol:
                raise AssertionError("embed differs between cuda and cpu")
    return launches


# the spec parity phase: repeating prompts and a small bias on three ids
# make the streams repeat, so the n-gram lookup hits, with partial accepts
SPEC_PROMPTS = [list(b"abcabcabcabcabcabc"), list(b"xyzxyzxyzxyzxy")]
SPEC_BIAS = {97: 3.0, 98: 3.0, 99: 3.0}


def _spec_run(eng, prompts, n, bias, counted) -> tuple[list, dict]:
    """Greedy streams of ``n`` + 1 tokens a prompt through a spec engine
    driven as the scheduler drives it (a window when the drafter
    proposes, a plain step when it declines); returns the streams and the
    launches of each wrapper in ``counted`` made inside windows."""
    from localai_tpu_torch.engine.runner import SKIP

    slots, out = [], []
    for p in prompts:
        s = eng.acquire_slot()
        slots.append(s)
        out.append([eng.admit(s, p, temperature=0.0, bias_row=bias)])
    in_windows = {n_: 0 for n_ in counted}
    while min(len(o) for o in out) <= n:
        before = {n_: w.launches for n_, w in counted.items()}
        rows = eng.step_spec_async()
        if rows is None:  # declined: a plain step
            toks = eng.target.step()
            for o, s in zip(out, slots):
                o.append(int(toks[s]))
                eng.drafter.observe(s, [int(toks[s])])
            continue
        host = np.asarray(rows)
        for n_, w in counted.items():
            in_windows[n_] += w.launches - before[n_]
        eng.observe_window(host)
        for o, s in zip(out, slots):
            o.extend(int(x) for x in host[:, s] if x != SKIP)
    return [o[:n + 1] for o in out], in_windows


def phase_spec_parity() -> dict:
    """Speculative decoding on the card and on the CPU (debug:small,
    float32 compute, num_slots 4, gamma 4): the greedy streams of a spec
    engine equal the spec-off streams of the same runner settings on both
    devices, in four modes — a paged f32 pool, int8 weights and pool,
    int4 weights and pool (each with the n-gram drafter; the w8/w4 kernel
    launches exactly 7L+1 times a verify window, at M = 4 x 5 = 20 rows),
    and a contiguous f32 cache with a draft model, a copy of the target
    whose lm_head carries seeded noise (debug:tiny's head dim 16 is not
    one the attention kernels are compiled for): its steps and resyncs
    launch K2 and K3 on the card. Returns the card's launches by mode."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.quant import quantize_params
    from localai_tpu_torch.models.registry import resolve_model
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )
    from localai_tpu_torch.ops.qmatmul import w4_matmul, w8_matmul
    from localai_tpu_torch.spec import ModelDrafter, NGramDrafter, SpecEngine

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention,
                "w8_matmul": w8_matmul, "w4_matmul": w4_matmul}
    model = resolve_model("debug:small", dtype="float32", device="cpu")
    cfg, gamma, n = model.cfg, 4, 32
    g = torch.Generator().manual_seed(1)
    draft_params = dict(model.params, lm_head=model.params["lm_head"]
                        + 0.005 * torch.randn(model.params["lm_head"].shape,
                                              generator=g))
    launches = {}
    for mode, weights in (("paged-float32", ""), ("paged-int8", "int8"),
                          ("paged-int4", "int4"),
                          ("contiguous-model-drafter", "")):
        paged = mode.startswith("paged")
        kv = weights or "float32"
        params = (quantize_params(model.params, weights, device="cpu")
                  if weights else model.params)
        bias = np.zeros(cfg.vocab_size, np.float32)
        if paged:
            bias[list(SPEC_BIAS)] = list(SPEC_BIAS.values())
        streams = {}
        for dev in ("cuda", "cpu"):
            def runner(p, dev=dev):
                return ModelRunner(cfg, _to(p, dev), num_slots=4,
                                   max_ctx=256, kv_dtype=kv,
                                   kv_block_tokens=16, prefill_chunk=32,
                                   paged=paged, device=dev)

            plain = runner(params)
            want, slots = [], []
            for p in SPEC_PROMPTS:
                slots.append(plain.acquire_slot())
                want.append([plain.admit(slots[-1], p, temperature=0.0,
                                         bias_row=bias)])
            for _ in range(n):
                toks = plain.step()
                for o, s in zip(want, slots):
                    o.append(int(toks[s]))
            del plain
            drafter = (NGramDrafter(4, gamma) if paged else
                       ModelDrafter(runner(draft_params), gamma))
            eng = SpecEngine(runner(params), drafter, gamma=gamma)
            for w in wrappers.values():
                w.launches = 0
            got, in_windows = _spec_run(eng, SPEC_PROMPTS, n, bias,
                                        wrappers)
            counts = {k: w.launches for k, w in wrappers.items()}
            t = eng.target
            rec = {"mode": mode, "device": dev, "windows": eng.total_windows,
                   "proposed": eng.total_proposed,
                   "accepted": eng.total_accepted,
                   "declined": eng.total_declined,
                   "verify_windows": t.verify_windows,
                   "target_decode_steps": t.decode_steps,
                   "target_fresh_prefills": t.fresh_prefills,
                   "launches": counts, "launches_in_windows": in_windows}
            if not paged:
                rec.update(draft_decode_steps=drafter.runner.decode_steps,
                           draft_fresh_prefills=drafter.runner.fresh_prefills)
            print("spec parity " + json.dumps(rec), flush=True)
            if got != want:
                raise AssertionError(f"spec parity {mode} {dev}: spec "
                                     f"{got} != plain {want}")
            if not (eng.total_windows > 0 and eng.total_accepted > 0):
                raise AssertionError(f"spec parity {mode} {dev}: no window "
                                     "or no accepted draft token")
            streams[dev] = got
            if dev == "cuda":
                L = cfg.num_layers
                if paged:
                    want_l = {"paged_decode_attention": L * t.decode_steps,
                              "decode_attention": 0, "prefill_attention": 0}
                    qk = {"int8": "w8_matmul",
                          "int4": "w4_matmul"}.get(weights)
                    if qk:
                        want_l[qk + " in windows"] = ((7 * L + 1)
                                                      * eng.total_windows)
                        counts[qk + " in windows"] = in_windows[qk]
                else:
                    d = drafter.runner
                    Ld = d.cfg.num_layers
                    want_l = {"paged_decode_attention": 0,
                              "decode_attention": (L * t.decode_steps
                                                   + Ld * d.decode_steps),
                              "prefill_attention": (L * t.fresh_prefills
                                                    + Ld * d.fresh_prefills)}
                    if not (d.decode_steps > 0 and d.fresh_prefills > 0):
                        raise AssertionError("the draft runner launched no "
                                             "K2 or no K3")
                got_l = {k: counts[k] for k in want_l}
                if got_l != want_l:
                    raise AssertionError(f"spec parity {mode}: launches "
                                         f"{got_l}, expected {want_l}")
                launches[mode] = {**counts, **{
                    f"{k} in windows": v for k, v in in_windows.items()}}
            del eng, drafter
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"spec parity {mode}: cuda and cpu differ")
    return launches


# the frozen parity phase: bias rows ban all but a band of ids, as a
# constraint's mask does (-1e30 over most of the vocab)
FROZEN_PROMPTS = [list(b"constrained slot"), list(b"free slot one"),
                  list(b"a"), list(b"the fourth prompt, longest of all")]


def _band_row(vocab: int, lo: int, width: int) -> np.ndarray:
    row = np.full(vocab, -1e30, np.float32)
    row[lo:lo + width] = 0.0
    return row


def _slot_kv_rows(r, slot: int, upto: int) -> list:
    """K/V rows [0, upto) of ``slot`` in every cache tensor (through the
    block table on a paged runner), on the CPU."""
    out = []
    for t in r.kv.stacked():
        if r.paged:
            rows = t[:, r.block_tables[slot].long()].transpose(2, 3)
            rows = rows.reshape(t.shape[0], -1, *rows.shape[3:])
        else:
            rows = t[:, slot].transpose(1, 2)
        out.append(rows[:, :upto].cpu())
    return out


def phase_frozen_parity() -> dict:
    """``step_frozen_n``, the dispatch of constrained decoding, on the card
    against the same runner on the CPU (debug:small, float32 compute): on
    a paged pool and a contiguous cache, each in f32 and int8, four slots
    behind band bias rows run frozen dispatches with one, two and three
    slots frozen and a plain step between; the rows equal the CPU's token
    for token, K1 (paged) or K2 (contiguous) launches exactly L x
    decode_steps, and a frozen slot's K/V rows (its pending token written
    at its unadvanced row on steps 1+) equal those after the next plain
    step, which writes that row again. Returns the card's launches by
    mode."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.quant import quantize_params
    from localai_tpu_torch.models.registry import resolve_model
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
    )

    model = resolve_model("debug:small", dtype="float32", device="cpu")
    cfg = model.cfg
    V, L, S = cfg.vocab_size, cfg.num_layers, 4
    plan = [(0,), (0, 2), (), (1, 2, 3), (0, 3)]   # () = a plain step
    launches = {}
    for paged in (True, False):
        for kv in ("float32", "int8"):
            mode = f"{'paged' if paged else 'contiguous'}-{kv}"
            kernel = paged_decode_attention if paged else decode_attention
            params = (quantize_params(model.params, kv, device="cpu")
                      if kv == "int8" else model.params)
            rows = {}
            for dev in ("cuda", "cpu"):
                r = ModelRunner(cfg, _to(params, dev), num_slots=S,
                                max_ctx=256, kv_dtype=kv,
                                kv_block_tokens=16, prefill_chunk=32,
                                paged=paged, device=dev)
                got = [[r.admit(r.acquire_slot(), p, temperature=0.0,
                                bias_row=_band_row(V, 97 + 4 * s, 6)
                                if s % 2 == 0 else None)
                        for s, p in enumerate(FROZEN_PROMPTS)]]
                kernel.launches = 0
                steps0 = r.decode_steps
                for frozen in plan:
                    if not frozen:
                        got.append(r.step().tolist())
                        continue
                    freeze = np.zeros(S, bool)
                    freeze[list(frozen)] = True
                    got.extend(r.step_frozen_n(freeze, 5).tolist())
                # the written-twice row of slot 0, frozen in the last
                # dispatch: its row P+1 before and after a plain step
                P = int(r.state.positions[0])
                before = _slot_kv_rows(r, 0, P + 1)
                got.append(r.step().tolist())
                after = _slot_kv_rows(r, 0, P + 1)
                steps = r.decode_steps - steps0
                if dev == "cuda":
                    torch.cuda.synchronize()
                    count = kernel.launches
                    if count != L * steps:
                        raise AssertionError(
                            f"frozen parity {mode}: {kernel.__name__} "
                            f"launched {count} times, expected {L} x "
                            f"{steps} decode steps")
                    launches[mode] = count
                same = all(torch.equal(a, b) for a, b in zip(before, after))
                if not same:
                    raise AssertionError(f"frozen parity {mode} {dev}: the "
                                         "frozen slot's rewritten K/V row "
                                         "changed")
                rows[dev] = got
                print("frozen parity " + json.dumps({
                    "mode": mode, "device": dev, "decode_steps": steps,
                    "frozen_dispatches": r.frozen_dispatches,
                    "kernel_launches": kernel.launches if dev == "cuda"
                    else 0, "rows": got}), flush=True)
                del r
            if rows["cuda"] != rows["cpu"]:
                raise AssertionError(f"frozen parity {mode}: cuda and cpu "
                                     "rows differ")
    return launches


def _post(url: str, body, timeout: float = 600,
          key: Optional[str] = None, method: Optional[str] = None,
          ctype: str = "application/json", cid: str = ""):
    """The open response of a request: ``body`` a dict sent as JSON, raw
    bytes, or None (a GET); ``key`` a bearer token, ``cid`` an
    X-Correlation-ID."""
    headers = {"Content-Type": ctype}
    if key is not None:
        headers["Authorization"] = f"Bearer {key}"
    if cid:
        headers["X-Correlation-ID"] = cid
    data = (json.dumps(body).encode() if isinstance(body, dict) else body)
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    return urllib.request.urlopen(req, timeout=timeout)


def phase_serve(card: str, quant: str = "", paged: bool = True,
                profile: bool = False, spec: bool = False,
                ref_texts: Optional[list] = None) -> dict:
    """Serve debug:llama3-8b over HTTP with bf16 weights and pool, or with
    ``quant`` ("int8"/"int4") weights and pool, or (``paged`` False) with
    bf16 weights over the contiguous cache; each with ``spec: false``,
    except that ``spec`` serves bf16 paged with no spec key, so the
    default turns speculative decoding on as a user gets it, and adds a
    sixth request whose logit bias makes its stream cycle (the n-gram
    lookup then hits). Returns {"launches": the launch counts of the
    timed run, "texts": the five texts}. The paged bf16 server without
    speculation also answers embeddings and rerank requests while it
    decodes."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.models.manager import ModelManager
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )
    from localai_tpu_torch.ops.qmatmul import w4_matmul, w8_matmul

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention,
                "w8_matmul": w8_matmul, "w4_matmul": w4_matmul}
    name = (f"llama3-8b-{quant or 'bf16'}{'' if paged else '-contiguous'}"
            f"{'-spec' if spec else ''}")
    engine = {"dtype": "bfloat16", "kv_dtype": quant or "bfloat16",
              "max_slots": 8, "kv_block_tokens": 64, "kv_paged": paged}
    if not spec:
        engine["spec"] = False
    if quant:
        engine["quantization"] = quant
    embeds = paged and not quant and not spec
    mcfg = ModelConfig.from_dict({
        "name": name, "model": "debug:llama3-8b", "context_size": 4096,
        "embeddings": embeds, "engine": engine,
    })
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    manager = ModelManager(AppConfig(device="cuda"), loader)
    server = APIServer(manager, "127.0.0.1", 0).start()
    sm = None
    try:
        t0 = time.monotonic()
        sm = manager.get(name)
        torch.cuda.synchronize()
        print(f"serve {name}: loaded (L={sm.runner.cfg.num_layers}, "
              f"D={sm.runner.cfg.hidden_size}) in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        lane = sm.scheduler.spec
        if spec != (lane is not None):
            raise AssertionError(f"{name}: speculation is "
                                 f"{'off' if lane is None else 'on'}")
        chat = server.url + "/v1/chat/completions"
        prompts = ["Write a haiku about paged attention.",
                   "What is the capital of France?",
                   "List three prime numbers.",
                   "Explain continuous batching in one sentence.",
                   "Say hello."]

        def body(i, stream=False):
            return {"model": name, "max_tokens": 32, "temperature": 0,
                    "stream": stream,
                    "messages": [{"role": "user", "content": prompts[i]}]}

        # warm-up request (first-call allocations), not counted
        json.loads(_post(chat, body(4)).read())
        torch.cuda.reset_peak_memory_stats()
        results: dict = {}
        errors: list = []

        def plain(i):
            try:
                results[i] = json.loads(_post(chat, body(i)).read())
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        def streamed(i):
            try:
                t = time.monotonic()
                ttft, text, last = None, "", None
                with _post(chat, body(i, stream=True)) as r:
                    for line in r:
                        line = line.strip()
                        if not line.startswith(b"data: {"):
                            continue
                        frame = json.loads(line[6:])
                        delta = frame["choices"][0]["delta"].get("content")
                        if delta and ttft is None:
                            ttft = time.monotonic() - t
                        text += delta or ""
                        last = frame
                results[i] = {"text": text, "ttft_s": ttft, "last": last}
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        def cyclic():
            try:
                results[5] = json.loads(_post(chat, {
                    "model": name, "max_tokens": 32, "temperature": 0,
                    "logit_bias": {"97": 10000},
                    "messages": [{"role": "user",
                                  "content": "Say a a a a a a a a."}]}
                ).read())
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        for w in wrappers.values():
            w.launches = 0
        steps0 = sm.runner.decode_steps
        fresh0 = sm.runner.fresh_prefills
        m0 = sm.scheduler.metrics()
        t0 = time.monotonic()
        threads = [threading.Thread(target=plain, args=(i,))
                   for i in range(4)]
        threads.append(threading.Thread(target=streamed, args=(4,)))
        if spec:
            threads.append(threading.Thread(target=cyclic))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        steps = sm.runner.decode_steps - steps0
        fresh = sm.runner.fresh_prefills - fresh0
        if errors:
            raise errors[0]
        ntok = 0
        for i in range(4):
            u = results[i]["usage"]["completion_tokens"]
            if u <= 0:
                raise AssertionError(f"request {i} returned no tokens")
            ntok += u
        su = results[4]["last"]["usage"]["completion_tokens"]
        if su <= 0:
            raise AssertionError("the streaming request returned no tokens")
        ntok += su
        m1 = sm.scheduler.metrics()
        counters = {}
        if spec:
            ntok += results[5]["usage"]["completion_tokens"]
            counters = {k: (m1[k] - m0[k] if k in ("spec_windows",
                                                   "spec_draft_tokens",
                                                   "spec_accepted_tokens",
                                                   "spec_suppressed")
                            else m1[k])
                        for k in m1 if k.startswith("spec_")}
            counters["verify_windows"] = lane.target.verify_windows
            if not (counters["spec_windows"] > 0
                    and counters["spec_accepted_tokens"] > 0):
                raise AssertionError(f"{name}: no verify window or no "
                                     f"accepted draft token: {counters}")
        L = sm.runner.cfg.num_layers
        # the decode kernel of the layout once per layer per decode step,
        # the other none; the prefill kernel once per layer per fresh
        # contiguous prefill (paged prefill chunks run plain attention)
        decode = "paged_decode_attention" if paged else "decode_attention"
        other = "decode_attention" if paged else "paged_decode_attention"
        want = {decode: L * steps, other: 0, "prefill_attention": L * fresh}
        got = {n: launches[n] for n in want}
        if steps <= 0 or got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want} "
                                 f"({L} layers, {steps} decode steps, "
                                 f"{fresh} fresh prefills)")
        if quant:
            qk = "w8_matmul" if quant == "int8" else "w4_matmul"
            if launches[qk] < (7 * L + 1) * steps:
                raise AssertionError(
                    f"{name}: {qk} launches {launches[qk]} < (7 x {L} + 1) "
                    f"x {steps} steps: an eligible decode matmul skipped "
                    "the kernel")
        embedded = phase_embed(server.url, name, sm.runner.cfg.hidden_size,
                               chat, body(0),
                               results[0]["choices"][0]["message"]["content"],
                               L) if embeds else 0
        texts = [results[i]["choices"][0]["message"]["content"]
                 for i in range(4)] + [results[4]["text"]]
        if ref_texts is not None:
            # equality is asserted in f32 by the spec parity phase; in
            # bf16 the verify's plain attention and K1 may break
            # near-ties differently, so it is reported here
            counters["texts_equal_to_spec_off"] = sum(
                a == b for a, b in zip(texts, ref_texts))
        if not embeds and not spec:
            again = json.loads(_post(chat, body(0)).read())
            if (again["choices"][0]["message"]["content"]
                    != results[0]["choices"][0]["message"]["content"]):
                raise AssertionError("repeating request 0 changed its text")
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "localai_tpu")]
        if bad:
            raise AssertionError(f"JAX-side modules imported: {bad[:5]}")
        print("serve: " + json.dumps({
            "card": card, "model": name, "weights": quant or "bfloat16",
            "kv_dtype": quant or "bfloat16",
            "kv_layout": "paged" if paged else "contiguous",
            "requests": 6 if spec else 5, "streaming": 1,
            "fresh_prefills": fresh,
            "completion_tokens": ntok, "wall_s": wall,
            "tokens_per_s": ntok / wall, "ttft_stream_s": results[4]["ttft_s"],
            "decode_steps": steps, "kernel_launches": launches,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9, **counters,
        }), flush=True)
        if profile:
            phase_profile(sm, verify=spec)
        launches["embedded_prefill_attention"] = embedded
        return {"launches": launches, "texts": texts}
    finally:
        # free this model before the next phase builds its own, so peak
        # memory is one model's
        server.shutdown()
        manager.shutdown()
        sm = manager = server = None
        gc.collect()
        torch.cuda.empty_cache()


# the tools serve: two tools whose arguments are enums and booleans only
TOOL_WEATHER = {"name": "get_weather", "description": "current weather",
                "parameters": {"type": "object", "properties": {
                    "unit": {"enum": ["celsius", "fahrenheit"]},
                    "precise": {"type": "boolean"}},
                    "required": ["unit", "precise"]}}
TOOL_MODE = {"name": "set_mode", "description": "switch the lights",
             "parameters": {"type": "object", "properties": {
                 "mode": {"enum": ["on", "off", "dim"]}}}}
TOOLS = [{"type": "function", "function": f}
         for f in (TOOL_WEATHER, TOOL_MODE)]
BOUNDED_SCHEMA = {"type": "object", "properties": {
    "answer": {"enum": ["yes", "no", "maybe"]}, "sure": {"type": "boolean"},
    "level": {"enum": [1, 2, 3]}}}


def _tools_bodies(name: str) -> list[dict]:
    """The eight concurrent chats of the tools serve, all greedy."""
    def chat(content, **kw):
        return {"model": name, "max_tokens": 128, "temperature": 0,
                "messages": [{"role": "user", "content": content}], **kw}

    schema = {"type": "json_schema", "json_schema": {
        "name": "verdict", "schema": BOUNDED_SCHEMA}}
    return [
        chat("What is the weather in Paris?", tools=TOOLS,
             tool_choice="auto"),
        chat("Turn the lights off, please.", tools=TOOLS,
             tool_choice="auto"),
        chat("Weather in Kyiv, precisely.", tools=TOOLS,
             tool_choice="required"),
        chat("Dim the lights.", tools=TOOLS, tool_choice={
            "type": "function", "function": {"name": "set_mode"}}),
        chat("Is the sky blue?", response_format=schema),
        chat("Will it rain tomorrow?", response_format=schema),
        chat("Describe a cat as JSON.",
             response_format={"type": "json_object"}),
        chat("Tell me a short story about a lighthouse.", max_tokens=96),
    ]


def _check_tool_calls(tool_calls: list, offered: list[dict]) -> None:
    """Each call names an offered function and its arguments are accepted
    by the DFA of that function's argument schema."""
    from localai_tpu_torch.functions import compile_dfa, schema_to_regex

    by_name = {f["name"]: f for f in offered}
    for tc in tool_calls:
        fn = by_name.get(tc["function"]["name"])
        if fn is None:
            raise AssertionError(f"tool call names {tc['function']['name']!r}"
                                 f", not one of {sorted(by_name)}")
        args = json.loads(tc["function"]["arguments"])
        params = fn["parameters"]
        args_schema = {"type": "object", "properties": params["properties"],
                       **({"required": params["required"]}
                          if "required" in params else {})}
        if not (isinstance(args, dict) and compile_dfa(
                schema_to_regex(args_schema)).matches(
                    tc["function"]["arguments"])):
            raise AssertionError(f"arguments {args!r} do not match "
                                 f"{fn['name']}'s schema")


def _synthetic_vocab(V: int = 128256, seed: int = 0) -> list[bytes]:
    """Ids 0-255 as their bytes, the rest 2-8 printable ASCII bytes from a
    seed: a stand-in for a Llama-3-sized vocabulary's pieces."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 9, size=V - 256)
    flat = rng.integers(32, 127, size=int(lens.sum()), dtype=np.uint8)
    cuts = np.concatenate([[0], np.cumsum(lens)])
    return [bytes([i]) for i in range(256)] + [
        flat[a:b].tobytes() for a, b in zip(cuts[:-1], cuts[1:])]


def phase_mask_rows(pattern: str) -> dict:
    """Host cost of a new DFA state's [V] mask row at a Llama-3 vocabulary
    size (128256 synthetic pieces): the C walk and fused select against
    the numpy walk, over the first states a walk of ``pattern``'s DFA
    meets, and the host memory each cached state holds (the row and the
    per-node final states)."""
    from localai_tpu_torch.functions import constraint as cst

    class SyntheticTokenizer:
        eos_ids = {0}

        def __init__(self, table):
            self.vocab_size = len(table)
            self._token_bytes_table = table

    t0 = time.perf_counter()
    tok = SyntheticTokenizer(_synthetic_vocab())
    c = cst.FSMConstraint(cst.compile_dfa(pattern), tok)
    trie_s = time.perf_counter() - t0
    states, st = [], c.dfa.start
    for b in b'{"name":"get_weather","arguments":{"unit":"celsius"':
        if st == c.dfa.DEAD:
            break
        states.append(st)
        st = c.dfa.step_byte(st, b)
    states = list(dict.fromkeys(states))[:12]
    c_ms, np_ms = [], []
    for state in states:
        t0 = time.perf_counter()
        row = c._row(state)
        c_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        plain = c.row_numpy(state)
        np_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(row, plain):
            raise AssertionError(f"mask row of state {state} differs from "
                                 "the numpy walk's")
    per_state = row.nbytes + c._finals[states[0]].nbytes
    out = {"vocab": tok.vocab_size, "trie_nodes": c.trie.n_nodes,
           "trie_build_s": trie_s, "states": len(states),
           "row_build_ms_c_median": float(np.median(c_ms)),
           "row_build_ms_numpy_median": float(np.median(np_ms)),
           "row_cache_bytes_per_state": per_state}
    print("mask rows: " + json.dumps(out), flush=True)
    return out


def _check_native_rows(tokenizer) -> dict:
    """The C trie walk is loaded, and every mask row cached so far for
    ``tokenizer`` (each DFA state the serve visited) equals the numpy
    walk's row. Returns the states checked and the cache's bytes."""
    from localai_tpu_torch.functions import constraint as cst

    if cst._native_fsm() is None:
        raise AssertionError("the C trie walk (native/fsm_walk.c) did not "
                             "load: constrained rows came from numpy")
    trie = cst.TokenTrie.for_tokenizer(tokenizer)
    n, nbytes = 0, 0
    for dfa in list(cst._DFA_CACHE.values()):
        masks, finals = dfa.__dict__.get("_vocab_caches", {}).get(
            trie, ({}, {}))
        if not masks:
            continue
        c = cst.FSMConstraint(dfa, tokenizer)
        for state, row in list(masks.items()):
            if not np.array_equal(row, c.row_numpy(state)):
                raise AssertionError(f"C mask row of state {state} differs "
                                     "from the numpy walk's")
            n += 1
        nbytes += sum(a.nbytes for a in masks.values())
        nbytes += sum(a.nbytes for a in finals.values())
    if n == 0:
        raise AssertionError("no constrained mask row was cached")
    return {"native_rows_checked": n, "row_cache_bytes": nbytes}


def phase_frozen_timing(sm, ctx_tokens: int = 512, steps: int = 16,
                        dispatches: int = 6) -> dict:
    """Step wall of a frozen dispatch against a plain pipelined one at the
    serving shape: every slot holds a ``ctx_tokens`` prompt; half the
    slots are frozen in ``step_frozen_n(freeze, steps)`` (synchronous),
    against ``step_n_async(steps)`` with two dispatches in flight, as the
    scheduler dispatches them. ms per decode step, host clock, after a warm-up
    dispatch of each."""
    r = sm.runner
    g = torch.Generator().manual_seed(1)
    slots = []
    for _ in range(r.num_slots):
        prompt = torch.randint(0, 256, (ctx_tokens,), generator=g).tolist()
        slots.append(r.acquire_slot())
        r.admit(slots[-1], prompt, temperature=0.0,
                reserve_tokens=ctx_tokens + 4 * dispatches * steps)
    freeze = np.zeros(r.num_slots, bool)
    freeze[: r.num_slots // 2] = True
    r.step_frozen_n(freeze, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(dispatches):
        r.step_frozen_n(freeze, steps)
    frozen_ms = (time.perf_counter() - t0) * 1e3 / (dispatches * steps)
    np.asarray(r.step_n_async(steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inflight = []
    for _ in range(dispatches):
        inflight.append(r.step_n_async(steps))
        if len(inflight) >= 2:
            np.asarray(inflight.pop(0))
    for t in inflight:
        np.asarray(t)
    plain_ms = (time.perf_counter() - t0) * 1e3 / (dispatches * steps)
    for s in slots:
        r.release(s)
    out = {"ctx_tokens": ctx_tokens, "steps_per_dispatch": steps,
           "frozen_slots": int(freeze.sum()), "slots": r.num_slots,
           "frozen_dispatch_ms_per_step": frozen_ms,
           "pipelined_dispatch_ms_per_step": plain_ms}
    print("frozen timing: " + json.dumps(out), flush=True)
    return out


def phase_serve_tools(card: str) -> dict:
    """The sixth serve, ``llama3-8b-bf16-tools``: debug:llama3-8b in bf16
    on the paged pool, 8 slots, context 4096, the default config (so
    speculation is on), answering eight concurrent greedy chats: tools
    under ``auto`` (two), ``required`` and a named function, two bounded
    ``json_schema`` answers, one ``json_object`` and one plain chat that
    rides the frozen dispatches; then a streamed ``required`` tools chat
    alone, and a chat whose stream cycles. Every constrained answer that
    ends with ``stop`` is accepted by its DFA; every tool call names an
    offered function with arguments its schema accepts; frozen dispatches
    ran; no verify window ran while a constrained slot was live, and
    windows ran again for the cycling chat; K1 launched once per layer per
    decode step of the eight chats;
    the C trie walk served every mask row, equal to the numpy walk's.
    Returns the launches and the figures."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.functions import (
        build_tool_regex,
        inject_no_action,
    )
    from localai_tpu_torch.functions import constraint as cst
    from localai_tpu_torch.models.manager import ModelManager
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )

    name = "llama3-8b-bf16-tools"
    mcfg = ModelConfig.from_dict({
        "name": name, "model": "debug:llama3-8b", "context_size": 4096,
        "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                   "max_slots": 8, "kv_block_tokens": 64}})
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    manager = ModelManager(AppConfig(device="cuda"), loader)
    server = APIServer(manager, "127.0.0.1", 0).start()
    try:
        t0 = time.monotonic()
        sm = manager.get(name)
        torch.cuda.synchronize()
        print(f"serve {name}: loaded in {time.monotonic() - t0:.1f}s",
              flush=True)
        sched, lane = sm.scheduler, sm.scheduler.spec
        if lane is None:
            raise AssertionError(f"{name}: speculation is off by default")
        # every verify window records whether a constrained slot was live
        beside: list = []
        orig = lane.step_spec_async

        def watched():
            beside.append(any(c.handle.request.constraint is not None
                              for c in list(sched._slots.values())))
            return orig()

        lane.step_spec_async = watched
        # every submitted request's handle, for its token ids and DFA
        handles: list = []
        submit = sched.submit

        def recorded(req):
            h = submit(req)
            handles.append(h)
            return h

        sched.submit = recorded
        chat = server.url + "/v1/chat/completions"
        bodies = _tools_bodies(name)
        # warm-up (first-call allocations and the DFA compiles), not counted
        for b in (bodies[2], bodies[4], bodies[6]):
            json.loads(_post(chat, dict(b, max_tokens=4)).read())
        handles.clear()
        beside.clear()
        wrappers = {"paged_decode_attention": paged_decode_attention,
                    "decode_attention": decode_attention,
                    "prefill_attention": prefill_attention}
        for w in wrappers.values():
            w.launches = 0
        r = sm.runner
        steps0, frozen0 = r.decode_steps, r.frozen_dispatches
        m0 = sched.metrics()
        results: dict = {}
        errors: list = []

        def run(i):
            try:
                results[i] = json.loads(_post(chat, bodies[i]).read())
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]
        launches = {n: w.launches for n, w in wrappers.items()}
        steps = r.decode_steps - steps0
        frozen = r.frozen_dispatches - frozen0
        m1 = sched.metrics()
        ntok = sum(results[i]["usage"]["completion_tokens"]
                   for i in range(len(bodies)))
        # a streamed tools chat alone: one tool_calls delta per call
        with _post(chat, dict(bodies[2], stream=True)) as resp:
            frames = [json.loads(line.strip()[6:]) for line in resp
                      if line.strip().startswith(b"data: {")]
        streamed = [tc for f in frames
                    for tc in f["choices"][0]["delta"].get("tool_calls", [])]
        if frames[-1]["choices"][0]["finish_reason"] != "tool_calls" or \
                not streamed:
            raise AssertionError(f"{name}: the streamed required chat sent "
                                 "no tool_calls delta")
        _check_tool_calls(streamed, [TOOL_WEATHER, TOOL_MODE])
        # no constrained slot is live now: a chat whose logit bias makes
        # its stream cycle gets verify windows again
        windows0 = lane.total_windows
        json.loads(_post(chat, {
            "model": name, "max_tokens": 96, "temperature": 0,
            "logit_bias": {"97": 10000},
            "messages": [{"role": "user", "content": "Say a a a a a."}]}
        ).read())
        resumed = lane.total_windows - windows0
        if resumed <= 0:
            raise AssertionError(f"{name}: no verify window ran after the "
                                 "constrained chats ended")
        # the answers
        finishes = [results[i]["choices"][0]["finish_reason"]
                    for i in range(len(bodies))]
        for i in range(4):
            msg = results[i]["choices"][0]["message"]
            _check_tool_calls(msg.get("tool_calls") or [],
                              [TOOL_WEATHER, TOOL_MODE])
        for i in (2, 3):
            if finishes[i] != "tool_calls":
                raise AssertionError(f"{name}: request {i} forced a call "
                                     f"but finished {finishes[i]!r}")
        for i in (4, 5):
            json.loads(results[i]["choices"][0]["message"]["content"])
        accepted = 0
        for h in handles:
            c = h.request.constraint
            if c is None or h.finish_reason != "stop":
                continue
            data = bytes(t for t in h.token_ids if t < 256)
            if not c.dfa.matches(data):
                raise AssertionError(f"{name}: a constrained answer that "
                                     f"ended with stop is outside its "
                                     f"grammar: {data!r}")
            accepted += 1
        if frozen <= 0:
            raise AssertionError(f"{name}: no frozen dispatch ran")
        if any(beside):
            raise AssertionError(f"{name}: a verify window ran beside a "
                                 "constrained slot")
        L = r.cfg.num_layers
        want = {"paged_decode_attention": L * steps, "decode_attention": 0,
                "prefill_attention": 0}
        if steps <= 0 or launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want} ({L} layers, {steps} steps)")
        native = _check_native_rows(sm.tokenizer)
        host_tokens = m1["constrained_tokens"] - m0["constrained_tokens"]
        host_s = m1["constraint_host_s"] - m0["constraint_host_s"]
        timing = phase_frozen_timing(sm)
        # the tool_choice=auto grammar of this serve, over a Llama-3-sized
        # vocabulary
        rows = phase_mask_rows(build_tool_regex(
            inject_no_action([TOOL_WEATHER, TOOL_MODE], sm.config.function),
            sm.config.function).pattern)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "localai_tpu")]
        if bad:
            raise AssertionError(f"JAX-side modules imported: {bad[:5]}")
        out = {"card": card, "model": name, "requests": len(bodies),
               "finish_reasons": finishes,
               "tool_calls": [len(results[i]["choices"][0]["message"].get(
                   "tool_calls") or []) for i in range(4)],
               "constrained_answers_accepted_by_dfa": accepted,
               "completion_tokens": ntok, "wall_s": wall,
               "tokens_per_s": ntok / wall, "decode_steps": steps,
               "frozen_dispatches": frozen,
               "window_attempts_beside_constrained": sum(beside),
               "verify_windows_after": resumed,
               "kernel_launches": launches,
               "constrained_tokens": host_tokens,
               "host_ms_per_constrained_token":
                   host_s * 1e3 / max(1, host_tokens),
               **native, **timing, **{f"mask_{k}": v for k, v in rows.items()}}
        print("serve tools: " + json.dumps(out), flush=True)
        cst._DFA_CACHE.clear()
        return {"launches": launches, "figures": out}
    finally:
        server.shutdown()
        manager.shutdown()
        manager = server = None
        gc.collect()
        torch.cuda.empty_cache()


# the templated serve: two model YAMLs written into a models dir and read
# by the port's own YAML reader (no PyYAML, no Jinja2 on the card), as a
# user's gallery files are
TEMPLATED = "llama3-8b-bf16-templates"
CHAT_TEMPLATED = "llama3-8b-bf16-chat-template"
TEMPLATED_YAML = '''\
# Llama-3-style prompt templates, Go syntax, in block scalars
name: llama3-8b-bf16-templates
model: debug:llama3-8b
context_size: 4096
system_prompt: You are a helpful assistant.
stopwords:
- <|eot_id|>
engine:
  dtype: bfloat16
  kv_dtype: bfloat16
  max_slots: 8
  kv_block_tokens: 64
template:
  chat_message: |-
    <|start_header_id|>{{if eq .RoleName "assistant"}}assistant{{else if eq .RoleName "system"}}system{{else if eq .RoleName "tool"}}tool{{else if eq .RoleName "user"}}user{{end}}<|end_header_id|>

    {{ if .FunctionCall -}}
    Function call:
    {{ else if eq .RoleName "tool" -}}
    Function response:
    {{ end -}}
    {{ if .Content -}}
    {{.Content -}}
    {{ else if .FunctionCall -}}
    {{ toJson .FunctionCall -}}
    {{ end -}}
    <|eot_id|>
  chat: "<|begin_of_text|>{{.Input}}\\n<|start_header_id|>assistant<|end_header_id|>\\n\\n"
  functions: |
    <|begin_of_text|><|start_header_id|>system<|end_header_id|>

    {{.SystemPrompt}} You may call these tools:
    {{range .Functions}}{{toJson .}}
    {{end}}<|eot_id|>{{.Input}}
    <|start_header_id|>assistant<|end_header_id|>
  completion: >-
    <|begin_of_text|><|start_header_id|>user<|end_header_id|>
    Continue the text: {{.Input}}<|eot_id|><|start_header_id|>assistant<|end_header_id|>
  edit: '<|begin_of_text|><|start_header_id|>system<|end_header_id|>


    {{.Instruction}}<|eot_id|><|start_header_id|>user<|end_header_id|>


    {{.Input}}<|eot_id|><|start_header_id|>assistant<|end_header_id|>

'
'''
# the guesser's llama3 family chat template, written out in full as a
# checkpoint's tokenizer_config.json carries it
LLAMA3_CHAT_TEMPLATE = (
    "<|begin_of_text|>{% for message in messages %}"
    "{% if message['role'] == 'system' %}"
    "<|start_header_id|>system<|end_header_id|>\n\n"
    "{{ message['content'] }}<|eot_id|>"
    "{% elif message['role'] == 'user' %}"
    "<|start_header_id|>user<|end_header_id|>\n\n"
    "{{ message['content'] }}<|eot_id|>"
    "{% elif message['role'] == 'assistant' %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n"
    "{{ message['content'] }}<|eot_id|>"
    "{% endif %}{% endfor %}"
    "{% if add_generation_prompt %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}")
CHAT_TEMPLATE_YAML = (
    "name: llama3-8b-bf16-chat-template\n"
    "model: debug:llama3-8b\n"
    "context_size: 4096\n"
    "stopwords: [\"<|eot_id|>\"]\n"
    "engine: {dtype: bfloat16, kv_dtype: bfloat16, max_slots: 8,\n"
    "         kv_block_tokens: 64}\n"
    "template:\n"
    "  chat_template: |-\n"
    + "".join("    " + line + "\n" if line else "\n"
              for line in LLAMA3_CHAT_TEMPLATE.split("\n")))


def _templated_chat(model: str, messages: list, **extra) -> dict:
    return {"model": model, "max_tokens": 64, "temperature": 0,
            "messages": messages, **extra}


# the eight concurrent chats: system + user, a multi-turn chat, a tools
# chat under required (the functions template), a chat on the
# chat_template model, a streamed chat and three plain chats
TEMPLATED_CHATS = [
    _templated_chat(TEMPLATED, [
        {"role": "system", "content": "Answer in one word."},
        {"role": "user", "content": "Name a prime number."}]),
    _templated_chat(TEMPLATED, [
        {"role": "system", "content": "Answer in French."},
        {"role": "user", "content": "Hello!"},
        {"role": "assistant", "content": "Bonjour !"},
        {"role": "user", "content": "How are you today?"}]),
    _templated_chat(TEMPLATED, [
        {"role": "user", "content": "What is the weather in Paris?"}],
        tools=TOOLS, tool_choice="required"),
    _templated_chat(CHAT_TEMPLATED, [
        {"role": "system", "content": "Be brief."},
        {"role": "user", "content": "Why is the sky blue?"}]),
    _templated_chat(TEMPLATED, [{"role": "user",
                                 "content": "Count to five."}], stream=True),
    _templated_chat(TEMPLATED, [{"role": "user", "content": "Say hello."}]),
    _templated_chat(TEMPLATED, [{"role": "user",
                                 "content": "List three colours."}]),
    _templated_chat(TEMPLATED, [{"role": "user",
                                 "content": "Write a haiku about caches."}]),
]
TEMPLATED_COMPLETION = {"model": TEMPLATED, "max_tokens": 32,
                        "temperature": 0, "n": 2,
                        "prompt": ["The capital of France is",
                                   "Once upon a time, a kernel"]}
TEMPLATED_EDIT = {"model": TEMPLATED, "max_tokens": 32, "temperature": 0,
                  "instruction": "Fix the grammar.",
                  "prompt": "The quick brown fox jump over the lazy dog."}
_L3 = "<|begin_of_text|><|start_header_id|>{}<|end_header_id|>\n\n"
_TURN = "<|start_header_id|>{}<|end_header_id|>\n\n{}<|eot_id|>"
_ASK = "\n<|start_header_id|>assistant<|end_header_id|>\n\n"
# the prompt each request must reach the scheduler with (held equal to the
# JAX package's rendering of the same YAMLs by tests/test_torch_templates)
TEMPLATED_GOLDEN = [
    "<|begin_of_text|>" + _TURN.format("system", "Answer in one word.")
    + "\n" + _TURN.format("user", "Name a prime number.") + _ASK,
    "<|begin_of_text|>" + "\n".join([
        _TURN.format("system", "Answer in French."),
        _TURN.format("user", "Hello!"),
        _TURN.format("assistant", "Bonjour !"),
        _TURN.format("user", "How are you today?")]) + _ASK,
    _L3.format("system") + "You are a helpful assistant. You may call these"
    " tools:\n" + "".join(json.dumps(f, separators=(",", ":")) + "\n"
                          for f in (TOOL_WEATHER, TOOL_MODE))
    + "<|eot_id|>" + _TURN.format("user", "What is the weather in Paris?")
    + "\n<|start_header_id|>assistant<|end_header_id|>\n",
    "<|begin_of_text|>" + _TURN.format("system", "Be brief.")
    + _TURN.format("user", "Why is the sky blue?")
    + "<|start_header_id|>assistant<|end_header_id|>\n\n",
] + ["<|begin_of_text|>" + _TURN.format("user", c) + _ASK
     for c in ("Count to five.", "Say hello.", "List three colours.",
               "Write a haiku about caches.")] + [
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|> Continue the "
    f"text: {p}<|eot_id|><|start_header_id|>assistant<|end_header_id|>"
    for p in TEMPLATED_COMPLETION["prompt"]] + [
    _L3.format("system") + "Fix the grammar.<|eot_id|>"
    + _TURN.format("user", TEMPLATED_EDIT["prompt"])
    + "<|start_header_id|>assistant<|end_header_id|>\n"]


def write_models_dir(root, docs: dict) -> None:
    """YAML files (name → text) into a models dir."""
    import pathlib

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for name, text in docs.items():
        (root / f"{name}.yaml").write_text(text)


def _render_ms(fn) -> tuple[float, float]:
    """Host ms of a first render (templates parsed) and a cached one."""
    t0 = time.perf_counter()
    first = fn()
    t1 = time.perf_counter()
    again = fn()
    t2 = time.perf_counter()
    if first != again:
        raise AssertionError("a cached render differs from the first")
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def phase_render_timing(models: str, loader, tokenizer) -> dict:
    """Host ms to render each kind of template, first (parse + render)
    and cached, through the port's template functions."""
    from localai_tpu_torch.api.openai import chat_messages
    from localai_tpu_torch.templates.cache import TemplateCache
    from localai_tpu_torch.templates.chat import (
        apply_tokenizer_template,
        build_chat_prompt,
        build_completion_prompt,
        build_edit_prompt,
        parsed_chat_template,
    )

    cfg, ct_cfg = loader.get(TEMPLATED), loader.get(CHAT_TEMPLATED)
    msgs = chat_messages(TEMPLATED_CHATS[1]["messages"])
    ct_msgs = chat_messages(TEMPLATED_CHATS[3]["messages"])
    # a 64-message conversation: rendering grows with the message count
    long_msgs = chat_messages(
        [{"role": "system", "content": "Be brief."}]
        + [{"role": ("user", "assistant")[i % 2],
            "content": f"turn {i}: " + "lorem ipsum dolor " * 6}
           for i in range(63)])
    ct_template = ct_cfg.template.chat_template
    out = {}
    for kind, fn in (
            ("chat_message+chat", lambda c: build_chat_prompt(c, cfg, msgs)),
            ("chat_template", lambda c: apply_tokenizer_template(
                tokenizer, ct_msgs, chat_template=ct_template)),
            ("chat_message+chat_64_messages",
             lambda c: build_chat_prompt(c, cfg, long_msgs)),
            ("chat_template_64_messages", lambda c: apply_tokenizer_template(
                tokenizer, long_msgs, chat_template=ct_template)),
            ("completion", lambda c: build_completion_prompt(
                c, cfg, TEMPLATED_COMPLETION["prompt"][0])),
            ("edit", lambda c: build_edit_prompt(
                c, cfg, TEMPLATED_EDIT["prompt"],
                TEMPLATED_EDIT["instruction"]))):
        cache = TemplateCache(models)
        parsed_chat_template.cache_clear()
        first, cached = _render_ms(lambda: fn(cache))
        out[f"render_ms_{kind}_first"] = first
        out[f"render_ms_{kind}_cached"] = cached
    return out


def phase_serve_templates(card: str) -> dict:
    """The seventh serve: ``llama3-8b-bf16-templates`` and
    ``llama3-8b-bf16-chat-template`` (debug:llama3-8b in bf16 on the paged
    pool, 8 slots, context 4096, the default config, so speculation is
    on), loaded from YAML files of a models dir through
    ``ConfigLoader.load_from_path``: Go templates in block scalars on the
    first, a Jinja ``chat_template`` on the second. They answer eight
    concurrent greedy chats (``TEMPLATED_CHATS``), then a two-prompt
    ``n: 2`` completion and an edit. Every request reaches the scheduler
    with the token ids of its golden prompt (``TEMPLATED_GOLDEN``); every
    ``n: 2`` pair of choices is identical; K1 launches once per layer per
    decode step of both engines; neither ``jinja2`` nor ``yaml`` is
    imported. Prints tokens/s, the streamed chat's TTFT, prompt tokens per
    request and host ms to render each kind of template."""
    import shutil
    import tempfile

    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )

    models = tempfile.mkdtemp(prefix="templated-models-")
    write_models_dir(models, {TEMPLATED: TEMPLATED_YAML,
                              CHAT_TEMPLATED: CHAT_TEMPLATE_YAML})
    loader = ConfigLoader(models)
    loader.load_from_path()
    if loader.names() != sorted([TEMPLATED, CHAT_TEMPLATED]):
        raise AssertionError(f"templated serve: loaded {loader.names()}")
    manager = ModelManager(AppConfig(model_path=models, device="cuda"),
                           loader)
    server = APIServer(manager, "127.0.0.1", 0).start()
    try:
        t0 = time.monotonic()
        sms = [manager.get(n) for n in (TEMPLATED, CHAT_TEMPLATED)]
        torch.cuda.synchronize()
        print(f"serve {TEMPLATED} + {CHAT_TEMPLATED}: loaded from YAML in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        for sm in sms:
            if sm.scheduler.spec is None:
                raise AssertionError(f"{sm.name}: speculation is off by "
                                     "default")
        submitted: list = []
        for sm in sms:
            def recorded(req, _submit=sm.scheduler.submit):
                h = _submit(req)
                submitted.append(h)
                return h
            sm.scheduler.submit = recorded
        chat = server.url + "/v1/chat/completions"
        for body in (TEMPLATED_CHATS[0], TEMPLATED_CHATS[2],
                     TEMPLATED_CHATS[3]):  # warm-up, not counted
            json.loads(_post(chat, dict(body, max_tokens=4)).read())
        render = phase_render_timing(models, loader, sms[0].tokenizer)
        wrappers = {"paged_decode_attention": paged_decode_attention,
                    "decode_attention": decode_attention,
                    "prefill_attention": prefill_attention}
        for w in wrappers.values():
            w.launches = 0
        submitted.clear()
        steps0 = [sm.runner.decode_steps for sm in sms]
        results: dict = {}
        errors: list = []

        def run(i):
            body = TEMPLATED_CHATS[i]
            try:
                if not body.get("stream"):
                    results[i] = json.loads(_post(chat, body).read())
                    return
                t = time.monotonic()
                ttft, text, last = None, "", None
                with _post(chat, body) as r:
                    for line in r:
                        line = line.strip()
                        if not line.startswith(b"data: {"):
                            continue
                        frame = json.loads(line[6:])
                        delta = frame["choices"][0]["delta"].get("content")
                        if delta and ttft is None:
                            ttft = time.monotonic() - t
                        text += delta or ""
                        last = frame
                results[i] = {"text": text, "ttft_s": ttft, "last": last}
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(TEMPLATED_CHATS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]
        chat_submitted = list(submitted)
        completion = json.loads(_post(server.url + "/v1/completions",
                                      TEMPLATED_COMPLETION).read())
        edit = json.loads(_post(server.url + "/v1/edits",
                                TEMPLATED_EDIT).read())
        launches = {n: w.launches for n, w in wrappers.items()}
        steps = sum(sm.runner.decode_steps - s0
                    for sm, s0 in zip(sms, steps0))
        # prompts: every request's token ids are its golden prompt's
        tok = sms[0].tokenizer
        want = sorted(tok.encode(TEMPLATED_GOLDEN[i], add_bos=True)
                      for i in range(len(TEMPLATED_CHATS)))
        got = sorted(list(h.request.prompt) for h in chat_submitted)
        if got != want:
            raise AssertionError("templated serve: a chat's prompt ids "
                                 "differ from its golden prompt")
        later = [list(h.request.prompt)
                 for h in submitted[len(chat_submitted):]]
        n_chats = len(TEMPLATED_CHATS)
        want_later = [tok.encode(TEMPLATED_GOLDEN[n_chats + i], add_bos=True)
                      for i in (0, 0, 1, 1, 2)]
        if later != want_later:
            raise AssertionError("templated serve: a completion or edit "
                                 "prompt differs from its golden prompt")
        # choices: each n: 2 pair of greedy choices is identical
        texts = [c["text"] for c in completion["choices"]]
        if [c["index"] for c in completion["choices"]] != [0, 1, 2, 3] or \
                texts[0] != texts[1] or texts[2] != texts[3]:
            raise AssertionError(f"templated serve: n=2 greedy choices "
                                 f"differ: {texts}")
        if edit["object"] != "edit" or not edit["choices"]:
            raise AssertionError("templated serve: the edit answer is "
                                 f"malformed: {edit}")
        # the required tools chat: a call, or its JSON cut at 64 tokens
        tools_finish = results[2]["choices"][0]["finish_reason"]
        if tools_finish == "tool_calls":
            _check_tool_calls(
                results[2]["choices"][0]["message"]["tool_calls"],
                [TOOL_WEATHER, TOOL_MODE])
        elif tools_finish != "length":
            raise AssertionError("templated serve: the required tools chat "
                                 f"finished {tools_finish!r}")
        L = sms[0].runner.cfg.num_layers
        want_k = {"paged_decode_attention": L * steps, "decode_attention": 0,
                  "prefill_attention": 0}
        if steps <= 0 or launches != want_k:
            raise AssertionError(f"templated serve: launches {launches}, "
                                 f"expected {want_k} ({L} layers, {steps} "
                                 "decode steps)")
        ntok = sum(results[i]["usage"]["completion_tokens"]
                   for i in results if i != 4)
        ntok += results[4]["last"]["usage"]["completion_tokens"]
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "localai_tpu",
                                      "jinja2", "yaml")]
        if bad:
            raise AssertionError(f"the templated serve imported {bad[:5]}")
        out = {"card": card, "models": [TEMPLATED, CHAT_TEMPLATED],
               "requests": n_chats, "streaming": 1,
               "completion_tokens": ntok, "wall_s": wall,
               "tokens_per_s": ntok / wall,
               "ttft_stream_s": results[4]["ttft_s"],
               "prompt_tokens": [len(p) for p in sorted(
                   (list(h.request.prompt) for h in chat_submitted),
                   key=len)],
               "finish_reasons": [
                   (results[i]["last"]["choices"][0]["finish_reason"]
                    if i == 4 else results[i]["choices"][0]["finish_reason"])
                   for i in range(n_chats)],
               "completion_choices": len(completion["choices"]),
               "edit_tokens": edit["usage"]["completion_tokens"],
               "decode_steps": steps, "kernel_launches": launches,
               **render}
        print("serve templates: " + json.dumps(out), flush=True)
        return {"launches": launches, "figures": out}
    finally:
        server.shutdown()
        manager.shutdown()
        manager = server = None
        shutil.rmtree(models, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# the templated parity phase: debug:small's weights (drawn once on the
# CPU and written as a checkpoint, so both devices load the same ones) in
# f32 from a YAML with a chat_message template, paged and contiguous
PARITY_TEMPLATE_YAML = '''\
name: {name}
model: {model}
context_size: 512
engine:
  dtype: float32
  kv_dtype: {kv}
  max_slots: 4
  kv_block_tokens: 16
  prefill_chunk: 32
  kv_paged: {paged}
template:
  chat_message: |-
    <|start_header_id|>{{{{if eq .RoleName "assistant"}}}}assistant{{{{else if eq .RoleName "system"}}}}system{{{{else}}}}user{{{{end}}}}<|end_header_id|>

    {{{{.Content}}}}<|eot_id|>
  chat: "<|begin_of_text|>{{{{.Input}}}}\\n<|start_header_id|>assistant<|end_header_id|>\\n\\n"
'''
PARITY_CHATS = [
    {"max_tokens": 16, "temperature": 0, "messages": [
        {"role": "system", "content": "Be brief."},
        {"role": "user", "content": "The paged kernel walks each table"}]},
    {"max_tokens": 16, "temperature": 0, "messages": [
        {"role": "user", "content": "hi"},
        {"role": "assistant", "content": "hello"},
        {"role": "user", "content": "again"}]},
]


def templated_greedy(models: str, name: str, device: str,
                     bodies: list) -> tuple[list, list]:
    """(prompt ids, greedy token ids) of each chat, served in turn
    through the port's chat endpoint from a models dir on ``device``."""
    from localai_tpu_torch.api import openai as oa
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager

    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=models, device=device),
                           loader)
    try:
        sm = manager.get(name)
        handles: list = []

        def recorded(req, _submit=sm.scheduler.submit):
            h = _submit(req)
            handles.append(h)
            return h

        sm.scheduler.submit = recorded
        for body in bodies:
            oa.chat(manager, dict(body, model=name))
        return ([list(h.request.prompt) for h in handles],
                [list(h.token_ids) for h in handles])
    finally:
        manager.shutdown()


def phase_templated_parity() -> dict:
    """debug:small in f32, loaded from a YAML with a chat_message
    template, paged (K1) and contiguous (K2, K3): the card's prompt ids
    and greedy tokens equal the CPU's, token for token. Returns the
    kernels' launches in the card's runs by layout."""
    import shutil
    import tempfile

    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention}
    from localai_tpu_torch.models.loader import write_llama_checkpoint
    from localai_tpu_torch.models.registry import resolve_model

    models = tempfile.mkdtemp(prefix="templated-parity-")
    small = resolve_model("debug:small", dtype="float32", device="cpu")
    ckpt = write_llama_checkpoint(f"{models}/small-ckpt", small.cfg,
                                  small.params)
    layouts = {"paged": ("small-paged", "true"),
               "contiguous": ("small-contiguous", "false")}
    write_models_dir(models, {
        name: PARITY_TEMPLATE_YAML.format(name=name, model=ckpt,
                                          kv="float32", paged=paged)
        for name, paged in layouts.values()})
    launches = {}
    try:
        for layout, (name, _) in layouts.items():
            runs = {}
            for dev in ("cuda", "cpu"):
                for w in wrappers.values():
                    w.launches = 0
                runs[dev] = templated_greedy(models, name, dev, PARITY_CHATS)
                if dev == "cuda":
                    launches[layout] = {n: w.launches
                                        for n, w in wrappers.items()}
            print(f"templated parity {layout}: prompts "
                  f"{[len(p) for p in runs['cpu'][0]]} tokens, greedy cpu "
                  f"{runs['cpu'][1]}, card {runs['cuda'][1]}; card launches "
                  f"{json.dumps(launches[layout])}", flush=True)
            if runs["cuda"] != runs["cpu"]:
                raise AssertionError(f"templated parity {layout}: the card's "
                                     "prompt ids or greedy tokens differ "
                                     "from the CPU's")
            need = (["paged_decode_attention"] if layout == "paged"
                    else ["decode_attention", "prefill_attention"])
            for n in need:
                if launches[layout][n] <= 0:
                    raise AssertionError(f"templated parity {layout}: no {n} "
                                         "launch")
    finally:
        shutil.rmtree(models, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# The checkpoint serve: a Llama-3-8B checkpoint directory with a
# tokenizer.json, read by the port's own reader

# Llama-3's pre-tokenizer split pattern, as its tokenizer.json carries it
LLAMA3_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# Llama-3's 256 special tokens, ids 128000..128255, by their published names
LLAMA3_SPECIAL_TOKENS = (
    ["<|begin_of_text|>", "<|end_of_text|>"]
    + [f"<|reserved_special_token_{i}|>" for i in range(4)]
    + ["<|start_header_id|>", "<|end_header_id|>",
       "<|reserved_special_token_4|>", "<|eot_id|>"]
    + [f"<|reserved_special_token_{i}|>" for i in range(5, 251)])
LLAMA3_REGULAR_TOKENS = 128000
# the fixed text the smoke's BPE merges are learned from
TOKENIZER_CORPUS = """\
A cache keeps the hot set of a program close to the processor. When the
processor asks for a line that is not there, the request goes out to the
next level of memory, and the line comes back some hundreds of cycles
later. Caches are built in levels: the first is small and fast, the last
is large and shared between the cores. A good program touches memory in
order, reuses what it has loaded, and keeps its working set inside the
cache it runs on. It's often said that we'd rather move compute to the
data than data to the compute; they've shown it again and again, and
you'll find it's true for attention kernels too.

The model reads a prompt, writes its keys and values into the paged pool,
and then decodes one token at a time for every slot of the batch. Each
decode step reads the whole context of every slot once. The scheduler
admits new requests between steps, streams their text as it is decoded,
and stops a request at its end-of-turn token or at its length limit.

def decode_step(runner, slots, positions):
    logits = runner.forward(slots, positions)
    return logits.argmax(-1).tolist()

for i in range(10):
    print(i, i * i, 2 ** i)

Numbers: 0 1 2 3 4 5 6 7 8 9 10 12 100 128 256 1024 4096 65536 2024 3.14159
The year 1999, the date 2024-10-17, the time 09:30:00, the price $12.50.
Paris, Berlin, Tokyo, New York and London are large cities. Say hello!
Bonjour, comment allez-vous ? Très bien, merci. Guten Tag! ¿Qué tal?
Привет, как дела? こんにちは、元気ですか。你好，最近怎么样？안녕하세요.
Why is the sky blue? Because air scatters short wavelengths more than
long ones. Count to five: one, two, three, four, five. List three colours:
red, green and blue. Write a haiku about caches: lines wait in the dark,
a miss walks the long bus home, warm rows hold the light.
"""
CHECKPOINT = "llama3-8b-bf16-checkpoint"


def _checkpoint_chat(messages: list, **extra) -> dict:
    return {"model": CHECKPOINT, "max_tokens": 64, "temperature": 0,
            "messages": messages, **extra}


def _u(text: str) -> dict:
    return {"role": "user", "content": text}


# the eight concurrent chats of the checkpoint serve (the fifth streamed)
CHECKPOINT_CHATS = [
    _checkpoint_chat([{"role": "system",
                       "content": "You are a concise assistant."},
                      _u("What does a cache miss cost?")]),
    _checkpoint_chat([_u("Translate 'the cache is warm' into French, "
                         "German and Japanese.")]),
    _checkpoint_chat([_u("What is 12345 × 678? Show the digits.")]),
    _checkpoint_chat([{"role": "system", "content": "Answer in one word."},
                      _u("Name a prime number above 100.")]),
    _checkpoint_chat([_u("Bonjour ! Comment ça va ? 😀")], stream=True),
    _checkpoint_chat([_u("hi"), {"role": "assistant",
                                 "content": "Hello! How can I help?"},
                      _u("Write a haiku about paged attention.")]),
    _checkpoint_chat([_u("Привет! Как дела? こんにちは。")]),
    _checkpoint_chat([_u("Fix this code:\r\ndef f(x):\n\treturn x+1\n")]),
]


def llama3_prompt(messages: list) -> str:
    """The guesser's llama3 family chat template, written out."""
    return ("<|begin_of_text|>" + "".join(
        f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
        f"{m['content']}<|eot_id|>" for m in messages)
        + "<|start_header_id|>assistant<|end_header_id|>\n\n")


# the prompt ids each chat must reach the scheduler with: what
# ``tokenizers`` gives for ``llama3_prompt`` of its messages over the
# smoke's tokenizer.json (held so by tests/test_torch_tokenizer.py)
CHECKPOINT_GOLDEN_IDS = [
    [128000, 128006, 115, 121, 115, 267, 109, 128007, 10, 10, 89, 280, 407,
     258, 660, 99, 345, 101, 406, 115, 446, 97, 110, 116, 46, 128009,
     128006, 5450, 128007, 10, 10, 87, 282, 116, 334, 111, 265, 258, 399,
     3314, 115, 269, 111, 300, 63, 128009, 128006, 97, 115, 115, 446, 97,
     110, 116, 128007, 10, 10],
    [128000, 128006, 5450, 128007, 10, 10, 84, 114, 97, 110, 115, 108, 97,
     267, 32, 39, 116, 257, 399, 307, 1032, 109, 39, 291, 116, 111, 32, 70,
     261, 110, 451, 44, 32, 71, 289, 109, 97, 110, 274, 32, 74, 97, 112,
     97, 110, 265, 101, 46, 128009, 128006, 97, 115, 115, 446, 97, 110,
     116, 128007, 10, 10],
    [128000, 128006, 5450, 128007, 10, 10, 87, 282, 116, 307, 32, 350, 51,
     52, 53, 32, 195, 151, 32, 54, 55, 56, 63, 32, 83, 104, 436, 259, 334,
     105, 103, 344, 46, 128009, 128006, 97, 115, 115, 446, 97, 110, 116,
     128007, 10, 10],
    [128000, 128006, 115, 121, 115, 267, 109, 128007, 10, 10, 65, 110, 115,
     119, 289, 291, 379, 751, 100, 46, 128009, 128006, 5450, 128007, 10,
     10, 78, 347, 101, 258, 3787, 101, 32, 110, 117, 109, 98, 289, 258, 98,
     111, 278, 32, 303, 48, 46, 128009, 128006, 97, 115, 115, 446, 97, 110,
     116, 128007, 10, 10],
    [128000, 128006, 5450, 128007, 10, 10, 66, 268, 106, 341, 32, 33,
     16398, 109, 279, 116, 32, 195, 167, 97, 32, 118, 97, 32, 63, 32, 240,
     159, 152, 128, 128009, 128006, 97, 115, 115, 446, 97, 110, 116,
     128007, 10, 10],
    [128000, 128006, 5450, 128007, 10, 10, 104, 105, 128009, 128006, 97,
     115, 115, 446, 97, 110, 116, 128007, 10, 10, 72, 101, 108, 294, 33,
     32, 72, 436, 269, 97, 110, 32, 73, 32, 257, 108, 112, 63, 128009,
     128006, 5450, 128007, 10, 10, 87, 114, 105, 267, 258, 412, 105, 107,
     117, 258, 98, 432, 271, 97, 318, 100, 6786, 116, 105, 268, 46, 128009,
     128006, 97, 115, 115, 446, 97, 110, 116, 128007, 10, 10],
    [128000, 128006, 5450, 128007, 10, 10, 208, 159, 209, 128, 208, 184,
     208, 178, 423, 209, 130, 33, 411, 154, 424, 208, 186, 411, 180, 423,
     208, 187, 424, 63, 32, 286, 147, 227, 130, 147, 286, 171, 286, 161,
     286, 175, 422, 130, 128009, 128006, 97, 115, 115, 446, 97, 110, 116,
     128007, 10, 10],
    [128000, 128006, 5450, 128007, 10, 10, 70, 105, 120, 11784, 1365, 58,
     13, 10, 270, 102, 276, 40, 120, 462, 9, 2527, 32, 120, 43, 49, 10,
     128009, 128006, 97, 115, 115, 446, 97, 110, 116, 128007, 10, 10],
]
CHECKPOINT_GOLDEN = [(llama3_prompt(c["messages"]), ids) for c, ids in
                     zip(CHECKPOINT_CHATS, CHECKPOINT_GOLDEN_IDS)]


def _train_bpe(words: dict, vocab: dict, merges: list, limit: int) -> None:
    """Greedy BPE over word counts: merge the most frequent adjacent pair
    (the lexically largest on a tie) until none occurs twice or the
    vocabulary holds ``limit`` tokens."""
    seqs = {w: list(w) for w in words}
    while len(vocab) < limit:
        counts: dict = {}
        for w, n in words.items():
            s = seqs[w]
            for pair in zip(s, s[1:]):
                counts[pair] = counts.get(pair, 0) + n
        if not counts:
            return
        (a, b), c = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if c < 2:
            return
        new = a + b
        merges.append(f"{a} {b}")
        vocab.setdefault(new, len(vocab))
        for w in words:
            s, out, i = seqs[w], [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(new)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out


def _fill_merges(vocab: dict, merges: list, limit: int) -> None:
    """Merges of two learned tokens in a fixed order until the vocabulary
    holds ``limit`` tokens: token i + tail j along the diagonals i + j =
    0, 1, 2, ...; each new token joins both lists (a tail has no space or
    newline)."""
    toks = list(vocab)[256:]
    ws = set("ĠĊĉč")
    tails = [t for t in toks if not set(t) & ws]
    s = 0
    while len(vocab) < limit:
        for i in range(max(0, s - len(tails) + 1), min(s + 1, len(toks))):
            a, b = toks[i], tails[s - i]
            new = a + b
            if new in vocab or "<|" in new:
                continue
            merges.append(f"{a} {b}")
            vocab[new] = len(vocab)
            toks.append(new)
            if not set(a) & ws:
                tails.append(new)
            if len(vocab) == limit:
                break
        s += 1


def llama3_tokenizer_spec() -> dict:
    """A Llama-3-shaped ``tokenizer.json`` (as a dict): byte-level BPE
    with Llama-3's split pattern and ``ignore_merges``, 128000 regular
    tokens and Llama-3's 256 special tokens at 128000..128255.

    The 256 byte tokens come first, then the merges a stdlib BPE learns
    over ``TOKENIZER_CORPUS`` (every pair that occurs twice or more), then
    merges of two earlier tokens in a fixed order (the lowest sum of the
    two ranks first; a space or a newline only in the left one) until
    there are 128000 regular tokens: so the vocabulary has Llama-3's size
    and every token is reachable by a merge."""
    from localai_tpu_torch.utils.hf_tokenizer import BYTE_CHAR, onig_regex

    words: dict = {}
    for w in onig_regex(LLAMA3_SPLIT_PATTERN).findall(TOKENIZER_CORPUS):
        w = "".join(BYTE_CHAR[b] for b in w.encode("utf-8"))
        words[w] = words.get(w, 0) + 1
    vocab = {BYTE_CHAR[b]: b for b in range(256)}
    merges: list = []
    _train_bpe(words, vocab, merges, LLAMA3_REGULAR_TOKENS)
    _fill_merges(vocab, merges, LLAMA3_REGULAR_TOKENS)
    bos = LLAMA3_SPECIAL_TOKENS[0]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": LLAMA3_REGULAR_TOKENS + i, "content": c,
             "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True}
            for i, c in enumerate(LLAMA3_SPECIAL_TOKENS)],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos,
                                      "ids": [LLAMA3_REGULAR_TOKENS],
                                      "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges}}


def write_llama3_tokenizer(model_dir) -> float:
    """Write ``llama3_tokenizer_spec()`` as ``model_dir/tokenizer.json``;
    returns the seconds it took."""
    import pathlib

    t0 = time.monotonic()
    model_dir = pathlib.Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "tokenizer.json").write_text(
        json.dumps(llama3_tokenizer_spec(), ensure_ascii=False),
        encoding="utf-8")
    return time.monotonic() - t0


# Meta-Llama-3-8B-Instruct's config.json as published on Hugging Face
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128009, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 8192, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.40.0.dev0", "use_cache": True,
    "vocab_size": 128256}
CHECKPOINT_KEYS = ("smoke-key-one", "smoke-key-two")


def _scratch_dir(prefix: str, need_bytes: int) -> str:
    """A new directory with ``need_bytes`` free: under the temp dir, else
    under the checkout's ``build/``; raises when neither has the room."""
    import pathlib
    import shutil
    import tempfile

    tried = []
    for base in (tempfile.gettempdir(),
                 str(pathlib.Path(__file__).resolve().parent / "build")):
        pathlib.Path(base).mkdir(parents=True, exist_ok=True)
        free = shutil.disk_usage(base).free
        tried.append(f"{base}: {free / 1e9:.1f} GB free")
        if free >= need_bytes:
            return tempfile.mkdtemp(prefix=prefix, dir=base)
    raise AssertionError(f"no room for {need_bytes / 1e9:.1f} GB "
                         f"({'; '.join(tried)})")


def write_checkpoint_dir(model_dir, cfg, params, dtype: str,
                         hf_config: dict) -> dict:
    """A checkpoint directory a user would point the server at: weights
    (``models.loader.write_llama_checkpoint``), ``hf_config`` as
    ``config.json``, ``generation_config.json`` with Llama-3-Instruct's
    two end ids, and the smoke's ``tokenizer.json``. Returns the seconds
    each part took."""
    import pathlib

    from localai_tpu_torch.models.loader import write_llama_checkpoint

    model_dir = pathlib.Path(model_dir)
    t0 = time.monotonic()
    write_llama_checkpoint(model_dir, cfg, params, dtype=dtype)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t_weights = time.monotonic() - t0
    (model_dir / "config.json").write_text(json.dumps(hf_config))
    (model_dir / "generation_config.json").write_text(json.dumps(
        {"bos_token_id": 128000, "eos_token_id": [128001, 128009]}))
    return {"weights_s": t_weights,
            "tokenizer_s": write_llama3_tokenizer(model_dir)}


def _prefix_accepted(dfa, data: bytes) -> bool:
    st = dfa.start
    for b in data:
        st = dfa.step_byte(st, b)
        if st == dfa.DEAD:
            return False
    return True


def phase_tokenizer_timing(ckpt: str) -> dict:
    """Host ms of the port's reader on the checkpoint's tokenizer.json:
    load, each golden prompt's encode first (the word cache cold) and
    again (cached), the constraint module's byte table over all 128256
    ids, and its trie."""
    from localai_tpu_torch.functions.constraint import (
        TokenTrie,
        token_bytes_table,
    )
    from localai_tpu_torch.utils.tokenizer import load_tokenizer

    t0 = time.perf_counter()
    tok = load_tokenizer(ckpt)
    load_ms = (time.perf_counter() - t0) * 1e3
    first, cached = [], []
    for text, ids in CHECKPOINT_GOLDEN:
        t0 = time.perf_counter()
        got = tok.encode(text, add_bos=True)
        t1 = time.perf_counter()
        again = tok.encode(text, add_bos=True)
        t2 = time.perf_counter()
        if got != ids or again != ids:
            raise AssertionError("the port's reader gives other ids than "
                                 "the golden prompt's")
        first.append((t1 - t0) * 1e3)
        cached.append((t2 - t1) * 1e3)
    t0 = time.perf_counter()
    table = token_bytes_table(tok)
    table_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    trie = TokenTrie(table)
    trie_ms = (time.perf_counter() - t0) * 1e3
    return {"tokenizer_load_ms": load_ms, "encode_ms_first": first,
            "encode_ms_cached": cached, "prompt_tokens": [
                len(ids) for _, ids in CHECKPOINT_GOLDEN],
            "token_bytes_table_ms": table_ms,
            "token_bytes_table_ids": len(table),
            "maskable_ids": sum(1 for b in table if b),
            "trie_nodes": trie.n_nodes, "trie_build_ms": trie_ms}


def phase_serve_checkpoint(card: str, root: Optional[Path] = None) -> dict:
    """The eighth serve, ``llama3-8b-bf16-checkpoint``: a checkpoint
    directory with Meta-Llama-3-8B-Instruct's config.json (full widths and
    depth), seeded random bf16 weights, generation_config.json and the
    smoke's 128256-id tokenizer.json, read by the port's own reader. The
    server starts through ``cli.main.build_server`` with
    ``LOCALAI_MODELS_PATH``, ``LOCALAI_API_KEYS`` (two keys) and
    ``LOCALAI_ADDRESS`` in the environment, from a YAML that names only
    the checkpoint (family template, stopwords and tokenizer are
    detected). Asserts, in order: ``/readyz`` open, a chat without a key
    or with a wrong one 401, with either key answered; eight concurrent
    greedy chats (one streamed) reach the scheduler with their golden
    prompt ids and the streamed deltas join to that chat's text; a chat
    whose logit_bias puts +100 on <|eot_id|> stops after one token with
    empty content; a ``tool_choice: required`` chat decodes inside its
    DFA over the real vocabulary; K1 launches 32 per decode step. With
    ``root`` the checkpoint is written under it and kept (the gallery
    serve serves its files); the caller removes it."""
    import os
    import pathlib
    import shutil

    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.functions.constraint import token_bytes_table
    from localai_tpu_torch.models.registry import resolve_model
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )

    keep = root is not None
    if root is None:
        root = pathlib.Path(_scratch_dir("checkpoint-serve-", 6_500_000_000))
    ckpt, models = root / "Meta-Llama-3-8B-Instruct", root / "models"
    saved_env = {k: os.environ.get(k) for k in (
        "LOCALAI_MODELS_PATH", "LOCALAI_API_KEYS", "LOCALAI_ADDRESS",
        "LOCALAI_PORT", "LOCALAI_CONFIG_PATH")}
    server = None
    try:
        t0 = time.monotonic()
        model = resolve_model("debug:llama3-8b", dtype="bfloat16", seed=11,
                              device="cuda")
        torch.cuda.synchronize()
        draw_s = time.monotonic() - t0
        # SMOKE_LAYERS' depth: the first layers of the drawn stacks
        hf_config = {**LLAMA3_8B_CONFIG,
                     "num_hidden_layers": SMOKE_LAYERS["checkpoint"]}
        written = write_checkpoint_dir(
            ckpt, dataclasses.replace(model.cfg,
                                      num_layers=SMOKE_LAYERS["checkpoint"]),
            model.params, "bfloat16", hf_config)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        size = sum(f.stat().st_size for f in ckpt.iterdir())
        print(f"checkpoint {CHECKPOINT}: {size / 1e9:.2f} GB written in "
              f"{written['weights_s']:.1f}s (+ tokenizer.json "
              f"{written['tokenizer_s']:.1f}s; weights drawn on the card in "
              f"{draw_s:.1f}s); card {card}", flush=True)
        models.mkdir()
        (models / f"{CHECKPOINT}.yaml").write_text(f"model: {ckpt}\n")
        os.environ.update({
            "LOCALAI_MODELS_PATH": str(models),
            "LOCALAI_API_KEYS": ",".join(CHECKPOINT_KEYS),
            "LOCALAI_ADDRESS": "127.0.0.1", "LOCALAI_PORT": "0",
            "LOCALAI_CONFIG_PATH": str(root / "configuration")})
        server = build_server(["run"]).start()
        manager = server.manager
        t0 = time.monotonic()
        sm = manager.get(CHECKPOINT)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        tok = sm.tokenizer
        if type(tok).__name__ != "HFTokenizer" or tok.vocab_size != 128256 \
                or tok.eos_ids != {128001, 128009} or tok.bos_id != 128000:
            raise AssertionError(f"{CHECKPOINT}: tokenizer {type(tok)} "
                                 f"{tok.vocab_size} {tok.eos_ids}")
        if (sm.runner.cfg.num_layers != hf_config["num_hidden_layers"]
                or sm.runner.cfg.vocab_size != hf_config["vocab_size"]
                or sm.scheduler.spec is None):
            raise AssertionError(f"{CHECKPOINT}: not the checkpoint's "
                                 "depth and vocabulary, or not speculating")
        print(f"checkpoint {CHECKPOINT}: loaded in {load_s:.1f}s "
              f"(template {sm.config.template.chat_template is not None}, "
              f"stopwords {sm.config.stopwords}); card {card}", flush=True)
        chat = server.url + "/v1/chat/completions"
        # keys: /readyz is open, chats need one of the two
        with urllib.request.urlopen(server.url + "/readyz",
                                    timeout=60) as r:
            if r.status != 200:
                raise AssertionError("/readyz without a key is not 200")
        short = dict(CHECKPOINT_CHATS[0], max_tokens=4)
        for key in (None, "not-a-key"):
            try:
                _post(chat, short, key=key).read()
            except urllib.error.HTTPError as e:
                if e.code != 401:
                    raise
            else:
                raise AssertionError(f"a chat with key {key!r} was answered")
        for key in CHECKPOINT_KEYS:
            json.loads(_post(chat, short, key=key).read())
        submitted: list = []

        def recorded(req, _submit=sm.scheduler.submit):
            h = _submit(req)
            submitted.append(h)
            return h

        sm.scheduler.submit = recorded
        wrappers = {"paged_decode_attention": paged_decode_attention,
                    "decode_attention": decode_attention,
                    "prefill_attention": prefill_attention}
        for w in wrappers.values():
            w.launches = 0
        steps0 = sm.runner.decode_steps
        results: dict = {}
        errors: list = []

        def run(i):
            body = CHECKPOINT_CHATS[i]
            key = CHECKPOINT_KEYS[i % 2]
            try:
                if not body.get("stream"):
                    results[i] = json.loads(_post(chat, body,
                                                  key=key).read())
                    return
                t = time.monotonic()
                ttft, deltas, last = None, [], None
                with _post(chat, body, key=key) as r:
                    for line in r:
                        line = line.strip()
                        if not line.startswith(b"data: {"):
                            continue
                        frame = json.loads(line[6:])
                        delta = frame["choices"][0]["delta"].get("content")
                        if delta and ttft is None:
                            ttft = time.monotonic() - t
                        if delta:
                            deltas.append(delta)
                        last = frame
                results[i] = {"deltas": deltas, "ttft_s": ttft,
                              "last": last}
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(CHECKPOINT_CHATS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]
        chats = list(submitted)
        got = sorted(list(h.request.prompt) for h in chats)
        if got != sorted(ids for _, ids in CHECKPOINT_GOLDEN):
            raise AssertionError(f"{CHECKPOINT}: a chat's prompt ids differ "
                                 "from its golden prompt's")
        stream_i = next(i for i, b in enumerate(CHECKPOINT_CHATS)
                        if b.get("stream"))
        streamed = next(h for h in chats if list(h.request.prompt)
                        == CHECKPOINT_GOLDEN[stream_i][1])
        if "".join(results[stream_i]["deltas"]) != streamed.text:
            raise AssertionError(f"{CHECKPOINT}: the streamed deltas do not "
                                 "join to the chat's text")
        ntok = sum(results[i]["usage"]["completion_tokens"]
                   for i in results if i != stream_i)
        ntok += results[stream_i]["last"]["usage"]["completion_tokens"]
        # <|eot_id|> forced: the chat stops after one token, empty
        eot = LLAMA3_REGULAR_TOKENS + LLAMA3_SPECIAL_TOKENS.index(
            "<|eot_id|>")
        if tok.encode("<|eot_id|>") != [eot]:
            raise AssertionError("<|eot_id|> is not one token")
        biased = json.loads(_post(chat, dict(
            CHECKPOINT_CHATS[1], logit_bias={str(eot): 100}),
            key=CHECKPOINT_KEYS[0]).read())
        choice = biased["choices"][0]
        if (choice["finish_reason"] != "stop"
                or choice["message"]["content"] != ""
                or biased["usage"]["completion_tokens"] != 0
                or submitted[-1].token_ids != []
                or submitted[-1].finish_reason != "stop"):
            raise AssertionError(f"{CHECKPOINT}: the <|eot_id|>-biased chat "
                                 f"gave {choice} {biased['usage']}")
        # a required tool call, inside its DFA over the real vocabulary
        tools = json.loads(_post(chat, dict(
            CHECKPOINT_CHATS[2], max_tokens=128, tools=TOOLS,
            tool_choice="required"), key=CHECKPOINT_KEYS[1]).read())
        h = submitted[-1]
        c = h.request.constraint
        table = token_bytes_table(tok)
        data = b"".join(table[t] for t in h.token_ids if table[t])
        finish = tools["choices"][0]["finish_reason"]
        if c is None or not _prefix_accepted(c.dfa, data) or (
                h.finish_reason == "stop" and not c.dfa.matches(data)):
            raise AssertionError(f"{CHECKPOINT}: the required tools chat "
                                 f"left its grammar: {data[:200]!r}")
        if finish == "tool_calls":
            _check_tool_calls(tools["choices"][0]["message"]["tool_calls"],
                              [TOOL_WEATHER, TOOL_MODE])
        elif finish != "length":
            raise AssertionError(f"{CHECKPOINT}: the required tools chat "
                                 f"finished {finish!r}")
        launches = {n: w.launches for n, w in wrappers.items()}
        steps = sm.runner.decode_steps - steps0
        L = sm.runner.cfg.num_layers
        want = {"paged_decode_attention": L * steps, "decode_attention": 0,
                "prefill_attention": 0}
        if steps <= 0 or launches != want:
            raise AssertionError(f"{CHECKPOINT}: launches {launches}, "
                                 f"expected {want} ({L} layers, {steps} "
                                 "decode steps)")
        timing = phase_tokenizer_timing(str(ckpt))
        out = {"card": card, "model": CHECKPOINT,
               "checkpoint_gb": size / 1e9,
               "checkpoint_write_s": written["weights_s"],
               "tokenizer_write_s": written["tokenizer_s"],
               "load_s": load_s, "requests": len(CHECKPOINT_CHATS),
               "streaming": 1, "completion_tokens": ntok, "wall_s": wall,
               "tokens_per_s": ntok / wall,
               "ttft_stream_s": results[stream_i]["ttft_s"],
               "finish_reasons": [
                   (results[i]["last"]["choices"][0]["finish_reason"]
                    if i == stream_i
                    else results[i]["choices"][0]["finish_reason"])
                   for i in range(len(CHECKPOINT_CHATS))],
               "tools_finish": finish, "tools_tokens": len(h.token_ids),
               "decode_steps": steps,
               "verify_windows": getattr(sm.runner, "verify_windows", None),
               "kernel_launches": launches, **timing}
        print("serve checkpoint: " + json.dumps(out), flush=True)
        return {"launches": launches, "figures": out}
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if server is not None:
            server.shutdown()
        # drop this frame's references before collecting, so the model
        # does not outlive the phase
        server = manager = sm = tok = None
        if keep:
            shutil.rmtree(models, ignore_errors=True)
        else:
            shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _small_128k(seed: int = 0):
    """debug:small's widths with Llama-3's vocabulary, rope base and ids:
    (config, f32 weights drawn on the CPU from a seed)."""
    import dataclasses

    from localai_tpu_torch.models.llama import init_params
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = dataclasses.replace(DEBUG_PRESETS["small"], vocab_size=128256,
                              rope_theta=500000.0, dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return cfg, init_params(cfg, gen, torch.device("cpu"))


def _small_hf_config(cfg) -> dict:
    return {"model_type": "llama", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_position_embeddings,
            "tie_word_embeddings": False, "bos_token_id": 128000,
            "eos_token_id": 128009}


CHECKPOINT_PARITY_YAML = """\
name: {name}
model: {model}
context_size: 512
engine:
  dtype: float32
  kv_dtype: float32
  max_slots: 4
  kv_block_tokens: 16
  prefill_chunk: 32
  kv_paged: {paged}
"""


def phase_checkpoint_parity(root: str) -> dict:
    """debug:small's widths with the 128256-id vocabulary, f32, from a
    checkpoint directory with the smoke's tokenizer.json (YAMLs naming
    only the checkpoint and the engine): the card's prompt ids and greedy
    tokens equal the CPU's on the paged (K1) and contiguous (K2, K3)
    layouts, and the prompts are the golden ones. Leaves the models dir
    under ``root`` for the entry-point phase."""
    import pathlib

    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention}
    root = pathlib.Path(root)
    cfg, params = _small_128k()
    write_checkpoint_dir(root / "small-128k", cfg, params, "float32",
                         _small_hf_config(cfg))
    layouts = {"paged": "true", "contiguous": "false"}
    write_models_dir(root / "models", {
        f"small-128k-{layout}": CHECKPOINT_PARITY_YAML.format(
            name=f"small-128k-{layout}", model=root / "small-128k",
            paged=paged) for layout, paged in layouts.items()})
    bodies = [dict(CHECKPOINT_CHATS[i], max_tokens=16) for i in (0, 5)]
    bodies = [{k: v for k, v in b.items() if k not in ("model", "stream")}
              for b in bodies]
    launches = {}
    for layout in layouts:
        runs = {}
        for dev in ("cuda", "cpu"):
            for w in wrappers.values():
                w.launches = 0
            runs[dev] = templated_greedy(str(root / "models"),
                                         f"small-128k-{layout}", dev, bodies)
            if dev == "cuda":
                launches[layout] = {n: w.launches
                                    for n, w in wrappers.items()}
        print(f"checkpoint parity {layout}: prompts "
              f"{[len(p) for p in runs['cpu'][0]]} tokens, greedy cpu "
              f"{runs['cpu'][1]}, card {runs['cuda'][1]}; card launches "
              f"{json.dumps(launches[layout])}", flush=True)
        if runs["cuda"] != runs["cpu"]:
            raise AssertionError(f"checkpoint parity {layout}: the card's "
                                 "prompt ids or greedy tokens differ from "
                                 "the CPU's")
        if runs["cpu"][0] != [CHECKPOINT_GOLDEN[i][1] for i in (0, 5)]:
            raise AssertionError(f"checkpoint parity {layout}: prompts are "
                                 "not the golden ones")
        need = (["paged_decode_attention"] if layout == "paged"
                else ["decode_attention", "prefill_attention"])
        for n in need:
            if launches[layout][n] <= 0:
                raise AssertionError(f"checkpoint parity {layout}: no {n} "
                                     "launch")
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_entry_point(card: str, root: str) -> dict:
    """The real entry point, in subprocesses: ``tokenize`` gives the
    golden ids (no weights read), ``version`` the package's version,
    ``run`` with ``LOCALAI_KV_DTYPE=int8`` serves a debug model on the
    card from an int8 pool, and ``run --mesh data=2`` exits 2 (the data
    axis is ROADMAP item 19 part 2; ``model`` is served)."""
    import os
    import pathlib
    import signal

    import localai_tpu_torch

    root = pathlib.Path(root)
    models = root / "models"
    repo = str(pathlib.Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-m", "localai_tpu_torch.cli.main"]
    text, ids = CHECKPOINT_GOLDEN[3]
    res = subprocess.run(cmd + ["tokenize", text, "--model",
                                "small-128k-paged", "--models-path",
                                str(models)], capture_output=True, text=True,
                         env=env, timeout=300, cwd=repo)
    if res.returncode != 0 or json.loads(res.stdout.strip()) != ids:
        raise AssertionError(f"tokenize: rc {res.returncode}, "
                             f"{res.stdout[-300:]} {res.stderr[-2000:]}")
    res = subprocess.run(cmd + ["version"], capture_output=True, text=True,
                         env=env, timeout=300, cwd=repo)
    if res.returncode != 0 or \
            res.stdout.strip() != localai_tpu_torch.__version__:
        raise AssertionError(f"version: {res.stdout} {res.stderr[-2000:]}")
    res = subprocess.run(cmd + ["run", "--mesh", "data=2",
                                "--models-path", str(models)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=repo)
    if res.returncode != 2 or "ROADMAP item 19 part 2" not in res.stderr:
        raise AssertionError(f"run --mesh data=2: rc "
                             f"{res.returncode}, {res.stderr[-2000:]}")
    dbg = root / "debug-models"
    write_models_dir(dbg, {"small-int8-kv": (
        "name: small-int8-kv\nmodel: debug:small\ncontext_size: 512\n"
        "engine: {dtype: bfloat16, max_slots: 2, kv_block_tokens: 64}\n")})
    port = _free_port()
    log_path = root / "run.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            cmd + ["run", "small-int8-kv", "--models-path", str(dbg),
                   "--address", "127.0.0.1", "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT, cwd=repo,
            env={**env, "LOCALAI_KV_DTYPE": "int8",
                 "LOCALAI_CONFIG_PATH": str(root / "configuration")})
    try:
        deadline = time.monotonic() + 240
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                    ready = json.loads(r.read())
                if "small-int8-kv" in ready["models_loaded"]:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("run did not come up: "
                                     + log_path.read_text()[-3000:])
            time.sleep(0.5)
        answer = json.loads(_post(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            {"model": "small-int8-kv", "max_tokens": 8, "temperature": 0,
             "messages": [{"role": "user", "content": "hi"}]}).read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    logged = log_path.read_text()
    pool = re.search(r"loaded model small-int8-kv .* kv=(\w+) (\w+)", logged)
    if pool is None or pool.groups() != ("paged", "int8") or \
            "on cuda" not in pool.group(0):
        raise AssertionError("run with LOCALAI_KV_DTYPE=int8: the pool is "
                             f"not int8 on the card: {logged[-3000:]}")
    out = {"card": card, "tokenize_ids": len(ids), "version":
           localai_tpu_torch.__version__, "fleet_replicas_rc": 2,
           "run_pool": "/".join(pool.groups()),
           "run_answer_tokens": answer["usage"]["completion_tokens"]}
    print("entry point: " + json.dumps(out), flush=True)
    return out


def phase_embed(url: str, name: str, hidden: int, chat: str, chat_body: dict,
                chat_text: str, L: int) -> int:
    """Embeddings and rerank requests sent while a repeat of a chat request
    decodes: one string, three strings (one ~1000 tokens), one token
    array, then a rerank of three documents. The prefill kernel must
    launch exactly L times per embedded input (the lock-guarded count
    loses nothing to the engine thread's launches) and the repeated chat
    must keep its text. Returns the prefill kernel's launches."""
    from localai_tpu_torch.ops.attention import prefill_attention

    prefill_attention.launches = 0
    long_text = ("The quick brown fox jumps over the lazy dog. " * 23)[:1000]
    asks = [("/v1/embeddings", {"input": "What is paged attention?"}, 1),
            ("/v1/embeddings", {"input": ["short", long_text,
                                          "a middle-sized sentence"]}, 3),
            ("/embeddings", {"input": [5, 6, 7, 8, 9, 10]}, 1),
            ("/v1/rerank", {"query": "capital of France",
                            "documents": ["Paris is the capital of France.",
                                          "Bananas are yellow.",
                                          "France is in Europe."]}, 4)]
    repeated: dict = {}
    errors: list = []

    def repeat():
        try:
            repeated.update(json.loads(_post(chat, chat_body).read()))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t = threading.Thread(target=repeat)
    t.start()
    t0 = time.monotonic()
    answers = [json.loads(_post(url + path, {"model": name, **body}).read())
               for path, body, _ in asks]
    wall = time.monotonic() - t0
    t.join()
    if errors:
        raise errors[0]
    if repeated["choices"][0]["message"]["content"] != chat_text:
        raise AssertionError("a chat decoded beside embeddings changed text")
    n_inputs = sum(n for _, _, n in asks)
    embedded = answers[:3]
    vecs = [d["embedding"] for r in embedded for d in r["data"]]
    rerank = answers[3]
    ok = (len(vecs) == 5 and all(len(v) == hidden for v in vecs)
          and all(np.isfinite(v).all() for v in vecs)
          and len(rerank["results"]) == 3
          and all(np.isfinite(r["relevance_score"])
                  for r in rerank["results"]))
    launches = prefill_attention.launches
    print("embed: " + json.dumps({
        "model": name, "inputs": n_inputs, "vectors": len(vecs),
        "rerank_order": [r["index"] for r in rerank["results"]],
        "prompt_tokens": [r["usage"]["prompt_tokens"] for r in embedded],
        "wall_s": wall, "prefill_attention_launches": launches}), flush=True)
    if not ok:
        raise AssertionError("embeddings or rerank returned a bad vector")
    if launches != L * n_inputs:
        raise AssertionError(f"prefill kernel launches {launches} != {L} "
                             f"layers x {n_inputs} embedded inputs")
    return launches


def phase_profile(sm, ctx_tokens: int = 1024, steps: int = 16,
                  verify: bool = False) -> None:
    """Where a decode step's time goes at the serving shape: every slot
    holds a ``ctx_tokens`` prompt, then ``steps`` decode steps run once
    plain (wall clock) and once under torch.profiler (device time by
    kernel). ``verify`` profiles verify windows (gamma 4, proposals the
    target rejects: one token a slot a window) instead of decode steps.
    Run with ``--profile``; not part of the default smoke."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = sm.runner
    g = torch.Generator().manual_seed(0)
    for _ in range(r.num_slots):
        prompt = torch.randint(0, 256, (ctx_tokens,), generator=g).tolist()
        r.admit(r.acquire_slot(), prompt, temperature=0.0,
                reserve_tokens=ctx_tokens + 8 * steps)
    props = np.zeros((r.num_slots, 4), np.int32)

    def run(n):
        if not verify:
            return r.step_n(n)
        for _ in range(n):
            rows = r.verify_async(props)
        return np.asarray(rows)

    run(2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    wall_plain = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall_prof = (time.perf_counter() - t0) / steps
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / steps
    busy = sum(kernels.values())

    def share(*subs):
        return sum(v for k, v in kernels.items()
                   if any(x in k.lower() for x in subs))

    attn = share("decode_kernel")  # K1 (paged) or K2 (contiguous)
    qmm = share("w8_kn_kernel", "w8_nk_kernel", "w4_kernel", "qmm_kernel",
                "qmm_reduce")
    gemm = share("gemm", "nvjet", "xmma", "cutlass", "cublas")
    print("profile: " + json.dumps({
        "kv_dtype": r.kv_dtype, "ctx_tokens": ctx_tokens,
        "program": "verify window" if verify else "decode step",
        "slots": r.num_slots, "steps": steps,
        "wall_ms_per_step": wall_plain * 1e3,
        "wall_ms_per_step_profiled": wall_prof * 1e3,
        "device_busy_ms_per_step": busy,
        # device busy time is taken under the profiler; against the
        # profiled wall it counts the profiler's own host cost as idle
        "device_idle_share_vs_profiled_wall": max(
            0.0, 1 - busy / (wall_prof * 1e3)),
        "device_idle_share_vs_plain_wall": max(
            0.0, 1 - busy / (wall_plain * 1e3)),
        "attention_kernel_ms_per_step": attn,
        "w8_w4_kernel_ms_per_step": qmm,
        "gemm_ms_per_step": gemm,
        "other_ms_per_step": busy - attn - qmm - gemm,
        "launches_per_step": sum(
            e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / steps,
    }), flush=True)
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile kernel: {v:9.4f} ms/step  {k[:110]}")
    # where the host's time goes: Python functions by own time (cProfile
    # inflates every call, so read the shares, not the absolute times)
    import cProfile
    import pstats

    prof_py = cProfile.Profile()
    prof_py.enable()
    run(steps)
    torch.cuda.synchronize()
    prof_py.disable()
    st = pstats.Stats(prof_py)
    total = sum(v[2] for v in st.stats.values())
    for (fname, line, func), v in sorted(st.stats.items(),
                                         key=lambda kv: -kv[1][2])[:12]:
        print(f"profile host: {v[2] / total:6.1%} own time, "
              f"{v[1] / steps:7.1f} calls/step  "
              f"{fname.split('/')[-1]}:{line}({func})")


# ---------------------------------------------------------------------------
# Mixtral-class sparse MoE: K4's expert grid, card/CPU parity, the serve
# ---------------------------------------------------------------------------

# Mixtral-8x7B-Instruct-v0.1's published config.json (source: the model's
# config.json on Hugging Face)
MIXTRAL_8X7B_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "rope_theta": 1e6,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "sliding_window": None,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "router_aux_loss_coef": 0.02, "torch_dtype": "bfloat16"}
MIXTRAL = "mixtral-8x7b-int8"
MOE_E, MOE_D, MOE_F = 8, 4096, 14336
MIXTRAL_PREFILL_CHUNK = 512   # the engine's default prefill_chunk


def expert_case(kind: str, M: int, dtype=torch.bfloat16, *, E=MOE_E,
                D=MOE_D, F=MOE_F, seed=0, timed=True) -> dict:
    """K4's expert grid on one MoE projection (``kind`` "up": x [M, D]
    shared by every expert against [E, D, F]; "down": x [M, E, F], each
    expert its own rows, against [E, F, D]) with random int8 weights and
    per-channel scales of synthetic_quantized_params' magnitude, held per
    row of every expert against ``w8_matmul_experts_ref``. Timed: the
    kernel, the plain version, and cuBLAS (one batched torch.matmul over
    the stack dequantized to x's dtype beforehand); the byte bound counts
    the int8 stack, the scales, x and out once."""
    from localai_tpu_torch.ops import qmatmul as tqm

    K, N = (D, F) if kind == "up" else (F, D)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-127, 128, (E, K, N), generator=g, dtype=torch.int8,
                      device="cuda")
    scale = (0.02 / 127) * (1 + 0.5 * torch.rand(
        (E, N), generator=g, device="cuda"))
    x = torch.randn((M, K) if kind == "up" else (M, E, K), generator=g,
                    device="cuda").to(dtype)

    def kernel():
        return tqm.w8_matmul_experts(x, q, scale)

    out = kernel()
    torch.cuda.synchronize()
    ref = tqm.w8_matmul_experts_ref(x.float(), q, scale)
    err, ok = 0.0, True
    for e in range(E):
        e_err, e_ok = _check_rows(f"w8_matmul_experts-{kind}", out[:, e],
                                  ref[:, e], dtype)
        err, ok = max(err, e_err), ok and e_ok
    rec = {"case": f"w8_matmul_experts-{kind}",
           "dtype": str(dtype).replace("torch.", ""), "M": M, "E": E,
           "K": K, "N": N, "max_abs_err": err,
           "max_ref": float(ref.abs().max())}
    if dtype == torch.bfloat16:
        rec["plan"] = tqm.qmm_split_plan(
            M, K, N, tqm.QMM_BK,
            torch.cuda.get_device_properties(0).multi_processor_count,
            "w8", E)
    del ref
    if timed:
        elem = x.element_size()
        nbytes = E * K * N + 4 * E * N + x.numel() * elem + M * E * N * elem
        w_lib = (q.to(dtype) * scale[:, None, :].to(dtype))
        xl = x[None] if kind == "up" else x.transpose(0, 1)  # [E|1, M, K]
        rec.update(ms=time_ms(kernel),
                   plain_ms=time_ms(lambda: tqm.w8_matmul_experts_ref(
                       x, q, scale), iters=5, warmup=1),
                   library_ms=time_ms(lambda: torch.matmul(xl, w_lib)),
                   **_bound(nbytes, 2 * M * E * K * N, dtype))
        del w_lib
    print("kernel case", json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"kernel case {rec['case']} {rec['dtype']} "
                             f"M={M}: error {err}")
    return rec


def phase_moe_kernel(card: str) -> dict:
    """K4's expert grid at Mixtral-8x7B's widths (8 experts, D 4096, F
    14336) at a decode step's M = 8 and a verify window's M = 40, bf16
    (timed; the up projection also in f32) and at the serve's 512-row
    prefill chunk (untimed), and at debug:small's MoE widths in f32 and
    bf16 at M = 8, 40 and a 300-row prefill chunk (untimed); prints one layer's expert
    products (gate, up: the "up" shape; down) against the bytes a layer
    must stream (1.409 GB) and against cuBLAS. Returns the timed records
    by "<kind>-m<M>"."""
    out = {}
    seed = 100
    for M in (8, SPEC_M):
        for kind in ("up", "down"):
            seed += 1
            out[f"{kind}-m{M}"] = expert_case(kind, M, seed=seed)
            gc.collect()
            torch.cuda.empty_cache()
        layer = {f: 2 * out[f"up-m{M}"][f] + out[f"down-m{M}"][f]
                 for f in ("ms", "library_ms", "bound_ms")}
        print(f"moe layer experts (Mixtral-8x7B, M={M}, bf16; gate + up + "
              f"down, 3 launches, {3 * MOE_E * MOE_D * MOE_F / 1e9:.3f} GB "
              f"of int8): {json.dumps(layer)}; per step x 32 layers: "
              f"{json.dumps({f: 32 * v for f, v in layer.items()})}; card "
              f"{card}", flush=True)
    seed += 1
    out["up-m8-f32"] = expert_case("up", 8, torch.float32, seed=seed)
    gc.collect()
    torch.cuda.empty_cache()
    # the largest prefill chunk the Mixtral serve gives the grid (the
    # engine's default prefill_chunk, 512 rows: 8 x 112 x 16 tiles of an
    # up projection), untimed
    for kind in ("up", "down"):
        seed += 1
        expert_case(kind, MIXTRAL_PREFILL_CHUNK, seed=seed, timed=False)
        gc.collect()
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        for M in (8, SPEC_M, 300):
            for kind in ("up", "down"):
                seed += 1
                expert_case(kind, M, dtype, E=4, D=256, F=512, seed=seed,
                            timed=False)
    return out


def _moe_small():
    """(cfg, params on the CPU): debug:small's widths (hidden 256,
    intermediate 512, 4 layers, 8/4 heads) with 4 experts, top 2, f32
    compute, int8 weights quantized by the port (experts per channel),
    drawn from a seed on the CPU."""
    import dataclasses

    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.quant import quantize_params
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = dataclasses.replace(DEBUG_PRESETS["small"], dtype="float32",
                              num_experts=4, num_experts_per_tok=2)
    params = tl.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    return cfg, quantize_params(params, "int8", device="cpu")


def phase_moe_parity() -> dict:
    """The card and the CPU on the same seeded MoE weights (``_moe_small``):
    prefill logits of ``models.llama.forward`` within 1e-4 (f32), then
    greedy tokens of a paged and a contiguous runner equal token for
    token, each decode step launching the expert kernel exactly 3 times a
    layer and the dense K4 4 times a layer plus the lm_head. Returns the
    card's launches by layout."""
    from localai_tpu_torch.engine import kvcache as kvc
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
    )
    from localai_tpu_torch.ops.qmatmul import w8_matmul, w8_matmul_experts

    cfg, params = _moe_small()
    L = cfg.num_layers
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)))
    logits = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        T = tokens.shape[1]
        mask = kvc.resume_mask(cfg, T, 0, T, device=dev).expand(2, T, T)

        def write(kv, k, v):
            return kv, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

        w8_matmul_experts.launches = 0
        h, _ = tl.forward(cfg, p, tokens.to(dev),
                          torch.arange(T, device=dev)[None].expand(2, T),
                          write, None, mask, tl.rope_table(cfg, T, device=dev))
        logits[dev] = tl.logits_from_hidden(cfg, p, h).float().cpu()
        if dev == "cuda" and w8_matmul_experts.launches != 3 * L:
            raise AssertionError(f"moe parity forward: expert kernel "
                                 f"launches {w8_matmul_experts.launches} != "
                                 f"3 x {L}")
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    print(f"moe parity logits: max abs diff {err} (tolerance 1e-4, "
          f"largest {float(logits['cpu'].abs().max())})", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"moe logits differ between cuda and cpu: {err}")
    prompts = [list(b"a mixture of experts routes each token"),
               list(b"top two")]
    steps = 16
    launches = {}
    for paged in (True, False):
        layout = "paged" if paged else "contiguous"
        seqs = {}
        for dev in ("cuda", "cpu"):
            kw = dict(kv_block_tokens=16, prefill_chunk=32) if paged else {}
            r = ModelRunner(cfg, _to(params, dev), num_slots=4, max_ctx=256,
                            kv_dtype="float32", paged=paged, device=dev,
                            **kw)
            slots = [r.acquire_slot() for _ in prompts]
            out = [[r.admit(s, p, temperature=0.0)]
                   for s, p in zip(slots, prompts)]
            for w in (w8_matmul, w8_matmul_experts, w8_matmul_experts.up,
                      w8_matmul_experts.down, paged_decode_attention,
                      decode_attention):
                w.launches = 0
            for _ in range(steps):
                row = r.step()
                for o, s in zip(out, slots):
                    o.append(int(row[s]))
            seqs[dev] = out
            if dev == "cuda":
                got = {"w8_matmul_experts": w8_matmul_experts.launches,
                       "w8_matmul_experts_up": w8_matmul_experts.up.launches,
                       "w8_matmul_experts_down":
                           w8_matmul_experts.down.launches,
                       "w8_matmul": w8_matmul.launches,
                       "decode": (paged_decode_attention if paged
                                  else decode_attention).launches}
                want = {"w8_matmul_experts": 3 * L * steps,
                        "w8_matmul_experts_up": 2 * L * steps,
                        "w8_matmul_experts_down": L * steps,
                        "w8_matmul": (4 * L + 1) * steps,
                        "decode": L * steps}
                print(f"moe parity {layout}: launches {json.dumps(got)}",
                      flush=True)
                if got != want:
                    raise AssertionError(f"moe parity {layout}: launches "
                                         f"{got}, expected {want}")
                launches[layout] = got
            del r
        print(f"moe parity {layout}: {seqs['cuda']}", flush=True)
        if seqs["cuda"] != seqs["cpu"]:
            raise AssertionError(f"moe greedy tokens differ between cuda "
                                 f"and cpu ({layout}): {seqs}")
    return launches


def _weight_bytes(params: dict) -> dict:
    """Bytes of a parameter tree on the device by group: the expert
    stacks, the attention projections (and router, norms), embed + head."""
    def nbytes(t):
        if hasattr(t, "q"):
            return (t.q.numel() * t.q.element_size()
                    + t.scale.numel() * t.scale.element_size())
        return t.numel() * t.element_size()

    out = {"experts": 0, "attention": 0, "embed_head": 0}
    for k, v in params["layers"].items():
        out["experts" if k in ("w_gate", "w_up", "w_down")
            else "attention"] += nbytes(v)
    out["embed_head"] = sum(nbytes(params[k]) for k in params
                            if k != "layers")
    out["total"] = sum(out.values())
    return out


def _chats(url: str, name: str, n: int = 5, max_tokens: int = 32,
           extra: Optional[dict] = None, key: Optional[str] = None) -> dict:
    """The serves' five greedy chats (the last streamed), concurrently,
    each body with ``extra``'s fields (and a bearer ``key`` when given):
    {"results": by index (each with its client wall "wall_s"), "wall_s",
    "ttft_s", "tokens"}."""
    prompts = ["Write a haiku about paged attention.",
               "What is the capital of France?",
               "List three prime numbers.",
               "Explain continuous batching in one sentence.",
               "Say hello."][:n]
    results: dict = {}
    errors: list = []

    def body(i, stream=False):
        return {"model": name, "max_tokens": max_tokens, "temperature": 0,
                "stream": stream,
                "messages": [{"role": "user", "content": prompts[i]}],
                **(extra or {})}

    def plain(i):
        try:
            t = time.monotonic()
            results[i] = json.loads(_post(url, body(i), key=key).read())
            results[i]["wall_s"] = time.monotonic() - t
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    def streamed(i):
        try:
            t = time.monotonic()
            ttft, text, last = None, "", None
            with _post(url, body(i, stream=True), key=key) as r:
                for line in r:
                    line = line.strip()
                    if not line.startswith(b"data: {"):
                        continue
                    frame = json.loads(line[6:])
                    delta = frame["choices"][0]["delta"].get("content")
                    if delta and ttft is None:
                        ttft = time.monotonic() - t
                    text += delta or ""
                    last = frame
            results[i] = {"text": text, "ttft_s": ttft, "last": last,
                          "wall_s": time.monotonic() - t}
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=plain, args=(i,))
               for i in range(n - 1)]
    threads.append(threading.Thread(target=streamed, args=(n - 1,)))
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    ntok = sum(results[i]["usage"]["completion_tokens"]
               for i in range(n - 1))
    ntok += results[n - 1]["last"]["usage"]["completion_tokens"]
    for i in range(n - 1):
        if results[i]["usage"]["completion_tokens"] <= 0:
            raise AssertionError(f"{name}: chat {i} returned no tokens")
    return {"results": results, "wall_s": wall, "tokens": ntok,
            "ttft_s": results[n - 1]["ttft_s"]}


def _counted(sm, wrappers: dict, fn) -> dict:
    """Run ``fn`` with every wrapper's count at 0; returns the counts and
    the runner's decode steps, verify windows and prefill chunks in it."""
    r = sm.runner
    for w in wrappers.values():
        w.launches = 0
    before = (r.decode_steps, r.verify_windows, r.prefill_chunks)
    res = fn()
    out = {n: w.launches for n, w in wrappers.items()}
    out.update(decode_steps=r.decode_steps - before[0],
               verify_windows=r.verify_windows - before[1],
               prefill_chunks=r.prefill_chunks - before[2], result=res)
    return out


def _synthetic_serving_model(mcfg, app, cfg, params):
    """The engine ``build_serving_model`` makes of a paged ``mcfg`` with
    the default spec settings, on weights the caller drew (the JAX
    package's bench builds the runner of its synthetic quantized models
    from ``synthetic_quantized_params`` the same way): a ModelRunner at
    the config's engine settings, the n-gram self-drafter, the scheduler."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.engine.scheduler import Scheduler
    from localai_tpu_torch.models.manager import ServingModel
    from localai_tpu_torch.spec import build_spec_engine
    from localai_tpu_torch.templates.cache import TemplateCache
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    eng = mcfg.engine
    runner = ModelRunner(
        cfg, params, num_slots=eng.max_slots,
        max_ctx=min(mcfg.context_size, cfg.max_position_embeddings),
        prefill_buckets=eng.prefill_buckets, kv_dtype=eng.kv_dtype,
        seed=mcfg.seed or 0, paged=True,
        kv_block_tokens=eng.kv_block_tokens, kv_num_blocks=eng.kv_num_blocks,
        prefill_chunk=eng.prefill_chunk, device=app.device)
    spec = build_spec_engine(runner, drafter="ngram",
                             model_path=app.model_path, gamma=eng.spec_gamma,
                             dtype=eng.dtype)
    tokenizer = ByteTokenizer()
    scheduler = Scheduler(
        runner, tokenizer,
        default_max_tokens=mcfg.parameters.max_tokens or 2048,
        multi_step=eng.decode_steps_per_dispatch,
        pipeline_depth=eng.pipeline_depth,
        stream_latency_target=eng.stream_latency_ms / 1000.0, spec=spec)
    return ServingModel(name=mcfg.name, config=mcfg, runner=runner,
                        scheduler=scheduler, tokenizer=tokenizer,
                        templates=TemplateCache(app.model_path))


def _one_model_manager(app, loader, sm):
    """A ModelManager that serves the one engine a phase built by hand
    (``sm``) beside whatever its loader names."""
    from localai_tpu_torch.models.manager import ModelManager

    class OneModel(ModelManager):
        def get(self, name):
            if name != sm.name:
                return super().get(name)
            sm.touch()
            return sm

        def loaded_names(self):
            return sorted({*super().loaded_names(), sm.name})

        def loaded_snapshot(self):
            return {**super().loaded_snapshot(), sm.name: sm}

        def shutdown(self):
            super().shutdown()
            sm.close()

    return OneModel(app, loader)


def phase_serve_mixtral(card: str, profile: bool = False) -> dict:
    """The Mixtral serve, ``mixtral-8x7b-int8``: Mixtral-8x7B-Instruct's
    published widths and depth (MIXTRAL_8X7B_CONFIG) with int8 weights
    drawn in quantized form on the card (``synthetic_quantized_params``,
    as the JAX package's bench builds its synthetic quantized models: the
    bf16 tree, 93 GB, would not fit), in the engine
    ``build_serving_model`` makes of the default config (a paged bf16
    pool, 8 slots, ctx 4096, n-gram speculation on), served through the
    port's scheduler and HTTP server: five greedy 32-token chats, one
    streamed. Asserts K1 = 32 per decode step; K4's expert grid 2 x 32 up
    and 32 down projections and K4 in all 7 x 32 + 1 = 225 launches per
    decode step, verify window and prefill chunk, exactly; peak device
    memory under 80 GB. Returns the launch counts."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.models.llama import LlamaConfig
    from localai_tpu_torch.models.registry import synthetic_quantized_params
    from localai_tpu_torch.ops.attention import paged_decode_attention
    from localai_tpu_torch.ops.qmatmul import w8_matmul, w8_matmul_experts

    import dataclasses

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "w8_matmul": w8_matmul,
                "w8_matmul_experts": w8_matmul_experts,
                "w8_matmul_experts_up": w8_matmul_experts.up,
                "w8_matmul_experts_down": w8_matmul_experts.down}
    cfg = dataclasses.replace(LlamaConfig.from_hf(MIXTRAL_8X7B_CONFIG),
                              dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = synthetic_quantized_params(cfg, "int8", seed=0, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0
    wb = _weight_bytes(params)
    print(f"serve {MIXTRAL}: int8 weights drawn on the card in {draw_s:.1f}s"
          f": {json.dumps({k: v / 1e9 for k, v in wb.items()})} GB "
          "(reckoned: 46.7 = 45.10 experts + 1.34 attention + 0.26 embed "
          "and head, scales beside)", flush=True)
    mcfg = ModelConfig.from_dict({
        "name": MIXTRAL, "model": "mixtral-8x7b-instruct",
        "context_size": 4096,
        "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                   "max_slots": 8, "kv_block_tokens": 64,
                   "quantization": "int8"}})
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    app = AppConfig(device="cuda")
    sm = manager = server = None
    try:
        sm = _synthetic_serving_model(mcfg, app, cfg, params)
        del params
        manager = _one_model_manager(app, loader, sm)
        server = APIServer(manager, "127.0.0.1", 0).start()
        if sm.scheduler.spec is None or not sm.runner.paged:
            raise AssertionError(f"{MIXTRAL}: not paged with speculation")
        chat = server.url + "/v1/chat/completions"
        json.loads(_post(chat, {"model": MIXTRAL, "max_tokens": 4,
                                "messages": [{"role": "user",
                                              "content": "hi"}]}).read())
        run = _counted(sm, wrappers, lambda: _chats(chat, MIXTRAL))
        res = run.pop("result")
        L = cfg.num_layers
        dispatches = (run["decode_steps"] + run["verify_windows"]
                      + run["prefill_chunks"])
        k4 = run["w8_matmul"] + run["w8_matmul_experts"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        print("serve: " + json.dumps({
            "card": card, "model": MIXTRAL, "weights": "int8",
            "weight_gb": wb["total"] / 1e9, "kv_dtype": "bfloat16",
            "kv_layout": "paged", "requests": 5, "streaming": 1,
            "completion_tokens": res["tokens"], "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens"] / res["wall_s"],
            "ttft_stream_s": res["ttft_s"], "max_memory_allocated_gb": peak,
            "k4_launches": k4, **run,
            **{k: v for k, v in sm.scheduler.metrics().items()
               if k.startswith("spec_")}}, default=str), flush=True)
        if run["paged_decode_attention"] != L * run["decode_steps"]:
            raise AssertionError(f"{MIXTRAL}: K1 launches "
                                 f"{run['paged_decode_attention']} != {L} x "
                                 f"{run['decode_steps']} steps")
        if (run["decode_steps"] <= 0
                or run["w8_matmul_experts_up"] != 2 * L * dispatches
                or run["w8_matmul_experts_down"] != L * dispatches
                or k4 != (7 * L + 1) * dispatches):
            raise AssertionError(
                f"{MIXTRAL}: K4 launches {run['w8_matmul']} dense + "
                f"{run['w8_matmul_experts_up']} expert up + "
                f"{run['w8_matmul_experts_down']} expert down, expected "
                f"(7 x {L} + 1) x {dispatches} dispatches")
        if not peak < 80:
            raise AssertionError(f"{MIXTRAL}: peak memory {peak} GB")
        # one plain decode step and one verify window on their own
        r = sm.runner
        s = r.acquire_slot()
        r.admit(s, list(b"Mixtral routes every token to two experts"),
                temperature=0.0, reserve_tokens=64)
        one = _counted(sm, wrappers, r.step)
        props = np.zeros((r.num_slots, 4), np.int32)
        win = _counted(sm, wrappers, lambda: np.asarray(
            r.verify_async(props)))
        r.release(s)
        for what, c, want in (("decode step", one, (1, 0)),
                              ("verify window", win, (0, 1))):
            got = c["w8_matmul"] + c["w8_matmul_experts"]
            print(f"serve {MIXTRAL}: one {what}: K4 {got} ({c['w8_matmul']}"
                  f" dense + {c['w8_matmul_experts']} expert grid), K1 "
                  f"{c['paged_decode_attention']}", flush=True)
            if ((c["decode_steps"], c["verify_windows"]) != want
                    or got != 7 * L + 1 or c["w8_matmul_experts_up"] != 2 * L
                    or c["w8_matmul_experts_down"] != L):
                raise AssertionError(f"{MIXTRAL}: one {what} launched K4 "
                                     f"{got} times: {c}")
        if profile:
            phase_profile(sm)
        run["texts"] = [res["results"][i]["choices"][0]["message"]["content"]
                        for i in range(4)]
        return run
    finally:
        if server is not None:
            server.shutdown()
        if manager is not None:
            manager.shutdown()
        elif sm is not None:
            sm.close()
        sm = manager = server = None
        gc.collect()
        torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# image and video chat (LLaVA): media fixtures, the vision parity phase,
# the group-1 kernel cases and the LLaVA-1.5-7B serve
# ---------------------------------------------------------------------------

MEDIA_DIR = Path(__file__).resolve().parent / "tests" / "data" / "media"
# the files scripts/make_media_fixtures.py writes (with PIL, where it is
# installed), each beside its PIL decode as <name>.ref.png
MEDIA_FIXTURES = ("photo.jpg", "progressive.jpg", "rgba.png", "video.gif")
# the CPU tests' JPEG tolerance against libjpeg-turbo (max, mean)
JPEG_TOL = (2, 0.25)
# LLaVA-1.5-7B as llava-hf/llava-1.5-7b-hf's config.json describes it; its
# text_config names vocab_size 32064, max_position_embeddings 4096 and
# rms_norm_eps 1e-5 and leaves the rest at transformers' LlamaConfig
# defaults (Llama-2-7B: 4096 wide, 11008, 32 layers, 32 heads, no GQA,
# untied head), written out here; vision_config is CLIP ViT-L/14-336
# (hidden_act quick_gelu, the CLIPVisionConfig default)
LLAVA_15_7B_CONFIG = {
    "model_type": "llava", "image_token_index": 32000,
    "vision_feature_layer": -2, "vision_feature_select_strategy": "default",
    "projector_hidden_act": "gelu",
    "text_config": {
        "model_type": "llama", "vocab_size": 32064, "hidden_size": 4096,
        "intermediate_size": 11008, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 32,
        "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "tie_word_embeddings": False},
    "vision_config": {
        "model_type": "clip_vision_model", "hidden_size": 1024,
        "image_size": 336, "intermediate_size": 4096,
        "num_attention_heads": 16, "num_hidden_layers": 24,
        "patch_size": 14, "projection_dim": 768,
        "hidden_act": "quick_gelu"},
}
LLAVA = "llava-1.5-7b-bf16"


def _data_uri(name: str) -> str:
    import base64

    mime = {"jpg": "image/jpeg", "png": "image/png",
            "gif": "image/gif"}[name.rsplit(".", 1)[1]]
    return (f"data:{mime};base64,"
            + base64.b64encode((MEDIA_DIR / name).read_bytes()).decode())


def phase_media() -> dict:
    """Decode each committed fixture with the port (no PIL on this
    machine) and hold it to its committed PIL decode: PNG and GIF byte for
    byte, JPEG within the CPU tests' tolerance. Prints host ms to decode
    and to ``preprocess`` (to 336 x 336) each; returns them by file."""
    from localai_tpu_torch.models.vision import VisionConfig, preprocess
    from localai_tpu_torch.utils import media

    cfg = VisionConfig()
    out = {}
    for name in MEDIA_FIXTURES:
        data = (MEDIA_DIR / name).read_bytes()
        ref = media.decode_image((MEDIA_DIR / (name + ".ref.png"))
                                 .read_bytes())
        t0 = time.perf_counter()
        frames = (media.decode_video_frames(data) if name.endswith(".gif")
                  else [media.decode_image(data)])
        decode_ms = (time.perf_counter() - t0) * 1e3
        got = np.concatenate(frames, axis=0)
        if got.shape != ref.shape:
            raise AssertionError(f"media {name}: shape {got.shape} != "
                                 f"{ref.shape}")
        d = np.abs(got.astype(np.int64) - ref)
        limit = JPEG_TOL if name.endswith(".jpg") else (0, 0.0)
        t0 = time.perf_counter()
        preprocess(frames, cfg)
        pre_ms = (time.perf_counter() - t0) * 1e3
        rec = {"file": name, "bytes": len(data), "frames": len(frames),
               "shape": list(frames[0].shape), "decode_ms": decode_ms,
               "preprocess_ms": pre_ms, "max_abs_diff": int(d.max()),
               "mean_abs_diff": float(d.mean()), "tolerance": limit}
        print("media " + json.dumps(rec), flush=True)
        if d.max() > limit[0] or d.mean() > limit[1]:
            raise AssertionError(f"media {name}: decode differs from PIL's "
                                 f"({int(d.max())}, {float(d.mean())})")
        out[name] = rec
    return out


def _mm_request(sm, text: str, images: list, vid_frames: Optional[list]):
    """(prompt ids, rows, positions) of a prompt with [img-N] / [vid-0]
    placeholders, expanded as the chat endpoint expands them."""
    from localai_tpu_torch.api.inference import (
        MMContent,
        expand_image_placeholders,
    )

    groups = []
    items = list(images)
    if vid_frames:
        groups.append((len(items), len(vid_frames)))
        items += vid_frames
    mm = MMContent(embeds=sm.vision.encode(items), video_groups=groups)
    return expand_image_placeholders(sm, text, mm)


def phase_vision_parity() -> dict:
    """A small LLaVA in float32 (debug:small's widths with the ``vit``
    tower, weights drawn on the CPU), card against CPU: the tower's
    embeddings of the fixtures within 1e-4; greedy tokens of an image
    chat (beside a text one) through the scheduler equal on a paged
    engine with n-gram speculation and on a contiguous one; launches
    exact: K1 = L per paged decode step, K3 = L per contiguous prefill
    (the multimodal one included), K2 = L per contiguous decode step.
    Returns the card's launches by layout."""
    import dataclasses
    import types

    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler
    from localai_tpu_torch.models import vision
    from localai_tpu_torch.models.registry import resolve_model
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )
    from localai_tpu_torch.spec import NGramDrafter, SpecEngine
    from localai_tpu_torch.utils import media
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention}
    model = resolve_model("debug:small", dtype="float32", device="cpu")
    L = model.cfg.num_layers
    vcfg = dataclasses.replace(vision.DEBUG_PRESETS["vit"], dtype="float32",
                               projection_dim=model.cfg.hidden_size)
    vparams = vision.init_params(vcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    imgs = [media.decode_image((MEDIA_DIR / n).read_bytes())
            for n in ("photo.jpg", "rgba.png")]
    frames = media.decode_video_frames((MEDIA_DIR / "video.gif")
                                       .read_bytes())
    sms = {dev: types.SimpleNamespace(
        vision=vision.VisionTower(vcfg, _to(vparams, dev), dev),
        tokenizer=ByteTokenizer(), image_token_id=5)
        for dev in ("cuda", "cpu")}
    emb = {dev: sm.vision.encode(imgs + frames) for dev, sm in sms.items()}
    err = float(np.abs(emb["cuda"] - emb["cpu"]).max())
    print(f"vision parity: tower embeddings {emb['cuda'].shape}, max abs "
          f"diff card vs CPU {err} (tolerance 1e-4)", flush=True)
    if not err <= 1e-4:
        raise AssertionError("vision tower embeddings differ between the "
                             "card and the CPU")
    prompt, rows, pos = _mm_request(
        sms["cpu"], "<user>what is in [img-0] and [img-1]? [vid-0]",
        imgs, frames)
    text = list(b"<user>no image here, just text.")
    launches = {}
    for paged in (True, False):
        mode = "paged-spec" if paged else "contiguous"
        toks = {}
        for dev in ("cuda", "cpu"):
            r = ModelRunner(model.cfg, _to(model.params, dev), num_slots=2,
                            max_ctx=256, kv_dtype="float32",
                            kv_block_tokens=16, prefill_chunk=32,
                            paged=paged, device=dev)
            spec = (SpecEngine(r, NGramDrafter(2, gamma=4), gamma=4)
                    if paged else None)
            sched = Scheduler(r, ByteTokenizer(), multi_step=4, spec=spec)
            for w in wrappers.values():
                w.launches = 0
            try:
                hs = [sched.submit(GenRequest(
                    prompt=p, max_new_tokens=24, temperature=0.0,
                    ignore_eos=True, mm_embeds=m, mm_positions=q))
                    for p, m, q in ((prompt, rows, pos),
                                    (text, None, None))]
                toks[dev] = [h.result(300).token_ids for h in hs]
            finally:
                sched.shutdown()
            counts = {n: w.launches for n, w in wrappers.items()}
            counts.update(decode_steps=r.decode_steps,
                          fresh_prefills=r.fresh_prefills,
                          verify_windows=r.verify_windows)
            print(f"vision parity {mode} {dev}: prompt {len(prompt)} ids "
                  f"({len(pos)} image rows), tokens {toks[dev]}, launches "
                  f"{json.dumps(counts)}", flush=True)
            if dev == "cuda":
                if paged:
                    want = {"paged_decode_attention": L * r.decode_steps,
                            "decode_attention": 0, "prefill_attention": 0}
                else:
                    want = {"paged_decode_attention": 0,
                            "decode_attention": L * r.decode_steps,
                            "prefill_attention": L * r.fresh_prefills}
                if (any(counts[k] != v for k, v in want.items())
                        or r.decode_steps <= 0
                        or (not paged and r.fresh_prefills != 2)):
                    raise AssertionError(f"vision parity {mode}: launches "
                                         f"{counts}, expected {want}")
                launches[mode] = counts
            del r
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"vision parity {mode}: greedy tokens "
                                 "differ between the card and the CPU")
    return launches


# GQA groups past the powers of two (K1/K2 on the next compiled
# group capacity with the rows past the group masked, K3 with the group
# read at run time), each at a published checkpoint's heads:
# (q heads, kv heads, head dim)
GROUP_SHAPES = {
    "g3": (24, 8, 128),     # Llama-3.2-3B
    "g5": (40, 8, 128),     # Qwen2.5-14B
    "g6": (48, 8, 128),     # Mixtral-8x22B
    "g7": (28, 4, 128),     # Qwen2.5-7B
    "g16": (128, 8, 128),   # Llama-3.1-405B
    "g3-hd64": (9, 3, 64),  # SmolLM-135M
    "g7-hd64": (14, 2, 64),  # Qwen2.5-0.5B
}
GROUP_TIMED = "g7"          # timed next to its bound and SDPA
GROUP_T = 2048              # K3's prompt; and a length below it that
GROUP_LEN = 1999            # leaves a block's left-over rows masked


def phase_kernel_groups() -> dict:
    """K1 (bf16 and int8 pools, at the split plan), K2 (bf16 cache) and K3
    (bf16, T = 2048 and a length of 1999 below it) at every group of
    ``GROUP_SHAPES``, each against its plain version at the phase's
    tolerances; the ``GROUP_TIMED`` cases timed beside their bound and
    SDPA. Returns those timed records."""
    timed = {}
    for i, (name, (Hq, Hkv, hd)) in enumerate(GROUP_SHAPES.items()):
        t = name == GROUP_TIMED
        shape = {"Hq": Hq, "Hkv": Hkv, "hd": hd}
        rec = {
            "k1": kernel_case(f"{name}-k1-bf16", torch.bfloat16, timed=t,
                              seed=70 + i, **shape),
            "k1-int8": kernel_case(f"{name}-k1-int8", torch.bfloat16,
                                   pool="int8", timed=t, seed=80 + i,
                                   **shape),
            "k2": decode_case(f"{name}-k2-bf16", torch.bfloat16, timed=t,
                              seed=90 + i, **shape),
            "k3": prefill_case(f"{name}-k3-T{GROUP_T}-bf16", torch.bfloat16,
                               GROUP_T, seed=100 + i, timed=t, **shape),
        }
        prefill_case(f"{name}-k3-T{GROUP_T}-len{GROUP_LEN}-bf16",
                     torch.bfloat16, GROUP_T, length=GROUP_LEN,
                     seed=110 + i, timed=False, **shape)
        if t:
            timed = rec
    return timed


def _group_cfg(g: int):
    """A small llama config at GQA group ``g`` (two kv heads of head dim
    64, two layers, the qwen2 family's q/k/v biases), float32."""
    from localai_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=512, hidden_size=2 * g * 64,
                       intermediate_size=512, num_layers=2,
                       num_heads=2 * g, num_kv_heads=2,
                       max_position_embeddings=512, attention_bias=True,
                       dtype="float32")


def phase_group_parity() -> dict:
    """cuda/cpu parity at GQA groups 3 and 7 on small float32 models:
    greedy tokens equal on the paged layout (float32 and int8 pools) and
    the contiguous one, and the contiguous runner's embed vectors (K3)
    within 1e-4 of their largest entry, as ``phase_parity`` holds them;
    returns the card runs' launches by mode."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.llama import init_params
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention}
    prompts = [list(b"A group of seven query heads shares a kv head"),
               list(b"hi"), list(range(3, 120))]
    launches = {}
    for g in (3, 7):
        cfg = _group_cfg(g)
        params = init_params(cfg, torch.Generator().manual_seed(g), "cpu")
        for paged, kv in ((True, "float32"), (True, "int8"),
                          (False, "float32")):
            mode = f"g{g}-{'paged' if paged else 'contiguous'}-{kv}"
            seqs, vecs = {}, {}
            for dev in ("cuda", "cpu"):
                r = ModelRunner(cfg, _to(params, dev), num_slots=4,
                                max_ctx=256, kv_dtype=kv,
                                kv_block_tokens=16, prefill_chunk=32,
                                paged=paged, device=dev)
                for w in wrappers.values():
                    w.launches = 0
                slots = [r.acquire_slot() for _ in prompts]
                out = [[r.admit(s, p, temperature=0.0)]
                       for s, p in zip(slots, prompts)]
                for _ in range(16):
                    toks = r.step()
                    for o, s in zip(out, slots):
                        o.append(int(toks[s]))
                seqs[dev] = out
                counts = {n: w.launches for n, w in wrappers.items()}
                if not paged:
                    vecs[dev] = [r.embed(p) for p in prompts[:2]]
                if dev == "cuda":
                    need = (["paged_decode_attention"] if paged
                            else ["decode_attention", "prefill_attention"])
                    if any(counts[n] <= 0 for n in need):
                        raise AssertionError(f"group parity {mode}: no "
                                             f"launch of {need}: {counts}")
                    launches[mode] = counts
                del r
            print(f"group parity {mode}: {seqs['cuda']} launches "
                  f"{json.dumps(launches[mode])}", flush=True)
            if seqs["cuda"] != seqs["cpu"]:
                raise AssertionError(f"group parity {mode}: greedy tokens "
                                     "differ between cuda and cpu")
            for a, b in zip(vecs.get("cuda", ()), vecs.get("cpu", ())):
                err = float(abs(a - b).max())
                tol = 1e-4 * float(abs(b).max())
                print(f"group parity {mode} embed: max abs diff {err} "
                      f"(tolerance {tol})", flush=True)
                if not err <= tol:
                    raise AssertionError(f"group parity {mode}: embed "
                                         "differs between cuda and cpu")
    return launches


# Qwen2.5-7B-Instruct's config.json as published on Hugging Face (28 query
# and 4 kv heads: a GQA group of 7)
QWEN25_7B_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "hidden_act": "silu",
    "hidden_size": 3584, "initializer_range": 0.02,
    "intermediate_size": 18944, "max_position_embeddings": 32768,
    "max_window_layers": 28, "model_type": "qwen2",
    "num_attention_heads": 28, "num_hidden_layers": 28,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "sliding_window": 131072, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "transformers_version": "4.43.1",
    "use_cache": True, "use_sliding_window": False, "vocab_size": 152064}
QWEN = "qwen2.5-7b-bf16"
# the spans of one served request, in order (the JAX package's
# EngineTelemetry)
REQUEST_SPANS = ["queued", "admitted", "prefill", "decode", "drained"]


def _get(url: str, key: Optional[str] = None) -> tuple:
    """(status, body bytes, wall ms) of a GET (with a bearer ``key``)."""
    t0 = time.monotonic()
    req = urllib.request.Request(
        url, headers={"Authorization": f"Bearer {key}"} if key else {})
    with urllib.request.urlopen(req, timeout=60) as r:
        body = r.read()
        return r.status, body, (time.monotonic() - t0) * 1e3


def _series(text: str, name: str, model: str) -> float:
    """The sum of ``name``'s samples labelled ``model`` in an OpenMetrics
    scrape."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") and f'model="{model}"' in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


def phase_telemetry(srv, chats: list, key: Optional[str] = None) -> dict:
    """After a serve: the scrape's TTFT count and requests equal the chats
    served, its generated tokens the tokens the clients were sent; one
    trace per chat at /v1/traces with the request spans in order (and
    ``first_sse_write`` once after the prefill on a streamed chat's, as
    the JAX package's SSE writers mark it), each under its HTTP span's
    trace id; /healthz and /version answer 200.
    ``chats`` is every chat of the serve (``_chats`` results); ``key`` the
    server's API key, if it has one."""
    url = srv.server.url
    n = sum(len(c["results"]) for c in chats)
    tokens = sum(c["tokens"] for c in chats)
    status, body, scrape_ms = _get(url + "/metrics", key)
    text = body.decode()
    # the first scrape pays each family's first use; a second one, warm
    scrape_again_ms = _get(url + "/metrics", key)[2]
    got = {"ttft_count": _series(text, "localai_ttft_seconds_count",
                                 srv.name),
           "requests": _series(text, "localai_requests_total", srv.name),
           "tokens": _series(text, "localai_tokens_generated_total",
                             srv.name)}
    if status != 200 or got != {"ttft_count": n, "requests": n,
                                "tokens": tokens}:
        raise AssertionError(f"{srv.name}: /metrics gave {got}, served "
                             f"{n} chats of {tokens} tokens")
    status, body, traces_ms = _get(
        url + f"/v1/traces?kind=request&model={srv.name}&limit=500", key)
    traces = json.loads(body)["traces"]
    names = [[c["name"] for c in t["children"]] for t in traces]
    # a streamed chat that sent content also marks its first SSE write
    streamed = sum(1 for c in chats for r in c["results"].values()
                   if "last" in r and r["text"])
    marked = [x for x in names if "first_sse_write" in x]
    if (len(traces) != n or len(marked) != streamed
            or any([s for s in x if s != "first_sse_write"] != REQUEST_SPANS
                   for x in names)
            or any(x.count("first_sse_write") != 1
                   or x.index("first_sse_write") < x.index("prefill")
                   for x in marked)):
        raise AssertionError(f"{srv.name}: /v1/traces holds {len(traces)} "
                             f"traces for {n} chats ({streamed} streamed): "
                             f"{names}")
    _, body, _ = _get(url + "/v1/traces?kind=http&limit=500", key)
    http_ids = {t["trace_id"] for t in json.loads(body)["traces"]}
    if any(t["trace_id"] not in http_ids for t in traces):
        raise AssertionError(f"{srv.name}: an engine trace has no HTTP span "
                             "under its trace id")
    for path in ("/healthz", "/version"):
        if _get(url + path)[0] != 200:
            raise AssertionError(f"{path} did not answer 200")
    rec = {"model": srv.name, "chats": n, "tokens": tokens,
           "scrape_ms": scrape_ms, "scrape_again_ms": scrape_again_ms,
           "scrape_bytes": len(text),
           "traces_ms": traces_ms, **got}
    print("telemetry: " + json.dumps(rec), flush=True)
    return rec


QWEN_KEY = "sk-observatory-smoke-key"
# phase-only settings of the observed serve: history snapshots every
# second, a flight ring that holds every dispatch of the serve
OBSERVATORY_ENV = {"LOCALAI_HISTORY_SNAPSHOT_S": "1",
                   "LOCALAI_FLIGHT_CAPACITY": "4096"}


def _trace_idle(events: list) -> dict:
    """The card's idle share over a Chrome trace's window: 1 - the union
    of its CUDA kernel intervals over the span of its complete ("X")
    events, CPU and device."""
    timed = [e for e in events if e.get("ph") == "X"
             and isinstance(e.get("ts"), (int, float))]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in timed
                   if e.get("cat") == "kernel")
    if not spans:
        return {"kernels": 0, "window_ms": 0.0, "idle_share": None}
    t0 = min(e["ts"] for e in timed)
    t1 = max(e["ts"] + e.get("dur", 0) for e in timed)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = max(1e-9, t1 - t0)
    return {"kernels": len(spans), "window_ms": window / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / window}


def _record_us(n: int = 10_000) -> float:
    """Median host µs of one ``FlightRecorder.record`` call."""
    from localai_tpu_torch.obs.flight import FlightRecorder

    rec = FlightRecorder(512)
    times = []
    for i in range(n):
        t = time.perf_counter()
        rec.record(program="decode_n", steps=16, dispatch_ms=30.0,
                   occupancy=0.5, queue_depth=1, kv_utilization=0.2,
                   tokens=16, gap_ms=1.0, sched_ms=0.5, launch_ms=20.0,
                   sync_ms=8.0)
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e6


def phase_observatory(srv, chats: list, key: str, dirs: dict) -> dict:
    """The engine observatory of a served model, read with the engine idle
    after ``chats`` (every chat of the serve, warm-up included): one flight
    record per dispatch, whose tokens sum to the tokens the clients were
    sent; the anatomy's phases tile every record; the usage ledger's
    identity (goodput + cancelled + error tokens == the ring's total) and
    one hashed tenant for the key, which appears in neither /metrics nor
    /v1/usage; one SLO event per chat, its TTFT p95 inside the clients'
    walls; the census's weights and KV equal the runner's tensors and its
    bytes in use ``torch.cuda.memory_allocated()``; the decode programs'
    achieved GB/s at most 105% of the roofline; a 2 s ``POST
    /backend/trace`` during a streamed chat holds K1's kernel; a history
    snapshot under ``dirs["history"]``. Prints one ``observatory:`` line
    (TPOT beside ``step_ms_p50``, the anatomy's fractions, the trace's
    idle share beside the bubble estimate of the same dispatches, the
    record's host µs)."""
    from localai_tpu_torch.obs import device as tdev
    from localai_tpu_torch.obs.ledger import LEDGER, derive_tenant

    url, name, sched = srv.server.url, srv.name, srv.sm.scheduler
    r = srv.sm.runner

    def get_json(path):
        status, body, ms = _get(url + path, key)
        if status != 200:
            raise AssertionError(f"{path} answered {status}")
        return json.loads(body), body.decode(), ms

    served = sum(c["tokens"] for c in chats)
    n_chats = sum(len(c["results"]) for c in chats)
    # -- flight ring: one record per dispatch, tokens = tokens sent --------
    fl, _, _ = get_json("/debug/flight?limit=4096")
    ring = fl["models"][name]
    recs = ring["records"]
    m = sched.metrics()
    want = m["dispatches"] + m["prefill_chunks"]
    if len(recs) != want or ring["dispatches"] != want:
        raise AssertionError(f"{name}: {len(recs)} flight records for "
                             f"{want} dispatches")
    if sum(x["tokens"] for x in recs) != served or \
            ring["tokens_total"] != served:
        raise AssertionError(f"{name}: flight tokens "
                             f"{sum(x['tokens'] for x in recs)} for "
                             f"{served} sent")
    for x in recs:
        if (x["gap_ms"] + x["sched_ms"] + x["launch_ms"] + x["sync_ms"]
                > x["dispatch_ms"] + 4e-3):
            raise AssertionError(f"{name}: phases over the wall: {x}")
    streamed = chats[-1]["results"][len(chats[-1]["results"]) - 1]
    n_str = streamed["last"]["usage"]["completion_tokens"]
    tpot_ms = ((streamed["wall_s"] - streamed["ttft_s"]) / max(1, n_str - 1)
               * 1e3)
    an, _, _ = get_json("/debug/anatomy?window=0")
    a = an["models"][name]
    # -- ledger identity, one hashed tenant, no raw key --------------------
    g = LEDGER.goodput_totals(name)
    if g["flight_tokens"] != sched.flight.total_tokens:
        raise AssertionError(f"{name}: ledger {g} against the ring's "
                             f"{sched.flight.total_tokens} tokens")
    usage, usage_text, _ = get_json("/v1/usage")
    rows = [x for x in usage["data"] if x["model"] == name]
    tenant = derive_tenant(key)
    if [x["tenant"] for x in rows] != [tenant] or \
            rows[0]["delivered_tokens"] != served:
        raise AssertionError(f"{name}: /v1/usage rows {rows}")
    _, raw, scrape_ms = _get(url + "/metrics", key)
    metrics_text = raw.decode()
    if key in usage_text or key in metrics_text:
        raise AssertionError("the raw API key is exposed")
    # -- SLO: one event per chat, TTFT p95 inside the clients' walls -------
    slo, _, _ = get_json("/v1/slo")
    w = slo["models"][name]["windows"]["30m"]
    walls = [x["wall_s"] * 1e3 for c in chats for x in c["results"].values()]
    if w["count"] != n_chats or not (
            0 < w["ttft_ms"]["p95"] <= max(walls)):
        raise AssertionError(f"{name}: /v1/slo {w} for {n_chats} chats "
                             f"of walls {walls}")
    # -- census against the runner and the allocator -----------------------
    dv, _, _ = get_json("/debug/devices?probe=0")
    allocated = torch.cuda.memory_allocated()
    cats = dv["census"]["by_category"]
    weights = sum(t.numel() * t.element_size()
                  for t in tdev._param_tensors(r.params))
    kv = sum(t.numel() * t.element_size() for t in (r.kv.k, r.kv.v))
    in_use = dv["devices"][0]["memory"]["bytes_in_use"]
    if cats["weights"] != weights or cats["kv_cache"] != kv or \
            in_use != allocated or dv["census"]["total_bytes"] != allocated:
        raise AssertionError(f"{name}: census {dv['census']}, in use "
                             f"{in_use}, allocated {allocated}, weights "
                             f"{weights}, kv {kv}")
    probe, _, _ = get_json("/debug/devices?probe_timeout=30")
    if not probe["probe"]["ok"]:
        raise AssertionError(f"device probe failed: {probe['probe']}")
    # -- program costs: the decode programs under the roofline -------------
    pr, _, _ = get_json("/debug/programs")
    peak = pr["roofline"]["peak_gbps"]
    S, ctx = r.num_slots, r.ctx_pad
    decode = [x for x in pr["programs"]
              if x["program"] in ("decode", "decode_n")
              and x.get("achieved_gbps") is not None
              and x["bytes_accessed"] == r._cost(
                  S, x["statics"].get("n", 1), ctx, S * ctx,
                  S)["bytes_accessed"]]
    if not decode or any(x["achieved_gbps"] > 1.05 * peak for x in decode):
        raise AssertionError(f"{name}: decode programs {decode} against "
                             f"{peak} GB/s")
    top = max(decode, key=lambda x: x["dispatches"])
    # -- a 2 s capture while a chat streams: K1 among its kernels ----------
    # the chat outlasts the capture, however long the profiler takes to
    # start in a large process (the window opens only once it has): the
    # client hangs up once the capture is written, and the server cancels
    # the chat
    body = {"model": name, "max_tokens": 2048, "temperature": 0,
            "ignore_eos": True, "stream": True,
            "messages": [{"role": "user", "content": "Count slowly."}]}
    captured = threading.Event()
    errors: list = []

    def stream():
        try:
            with _post(url + "/v1/chat/completions", body, key=key) as resp:
                for _line in resp:
                    if captured.is_set():
                        break
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    th = threading.Thread(target=stream)
    th.start()
    time.sleep(1.0)   # the chat is decoding
    t_cap = time.monotonic()
    try:
        with _post(url + "/backend/trace", {"seconds": 2.0},
                   key=key) as resp:
            cap = json.loads(resp.read())
    finally:
        captured.set()
    t_end = time.monotonic()
    th.join()
    if errors:
        raise errors[0]
    with open(os.path.join(cap["trace_dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    if not any("paged_decode_kernel" in k for k in kernels):
        raise AssertionError(
            f"the trace holds no K1 launch: {sorted(kernels)[:20]} "
            f"({len(events)} events, capture {t_end - t_cap:.1f} s)")
    idle = _trace_idle(events)
    same = [x for x in sched.flight.snapshot()
            if t_cap <= x["ts"] <= t_end and not x["compile"]]
    wall = sum(x["dispatch_ms"] for x in same)
    bubble = (sum(max(0.0, x["gap_ms"] + x["sched_ms"] + x["launch_ms"]
                      - x["sync_ms"]) for x in same) / wall
              if wall else None)
    # -- a history snapshot ------------------------------------------------
    hist = os.path.join(dirs["history"], "history.json")
    deadline = time.monotonic() + 10
    while not os.path.exists(hist) and time.monotonic() < deadline:
        time.sleep(0.2)
    if not os.path.exists(hist):
        raise AssertionError(f"no history snapshot at {hist}")
    rec = {
        "model": name, "records": len(recs), "dispatches": want,
        "tokens": served, "chats": n_chats,
        "step_ms_p50": ring["percentiles"]["step_ms_p50"],
        "step_ms_p99": ring["percentiles"]["step_ms_p99"],
        "tpot_streamed_ms": tpot_ms,
        "host_overhead_fraction": a["host_overhead_fraction"],
        "device_bubble_fraction": a["device_bubble_fraction"],
        "phase_share": a["phase_share"],
        "phase_ms_p50": {ph: a[f"{ph}_ms_p50"]
                         for ph in ("gap", "sched", "launch", "sync")},
        "ledger": {"delivered": g["delivered_tokens"],
                   "flight_tokens": g["flight_tokens"],
                   "tenant": tenant},
        "slo_ttft_ms": w["ttft_ms"], "slo_tpot_ms": w["tpot_ms"],
        "census": cats, "bytes_in_use": in_use,
        "weights_gb": weights / 1e9, "kv_gb": kv / 1e9,
        "probe_s": probe["probe"]["seconds"],
        "roofline": pr["roofline"], "decode_program": {
            k: top.get(k) for k in ("program", "statics", "dispatches",
                                    "dispatch_seconds_ema",
                                    "achieved_gbps", "bandwidth_fraction",
                                    "achieved_gflops", "flops_fraction")},
        "trace": {**idle, "k1_kernels": sorted(
            k for k in kernels if "paged_decode" in k),
            "bubble_estimate_same_dispatches": bubble,
            "dispatches_in_window": len(same)},
        "scrape_ms": scrape_ms, "scrape_bytes": len(metrics_text),
        "record_us": _record_us()}
    print("observatory: " + json.dumps(rec), flush=True)
    return rec


SELF_HEAL_ENV = {"LOCALAI_STALL_DEADLINE_S": "2", "LOCALAI_KV_CHECK": "1"}
SELF_HEAL_PROMPTS = ["Name a colour.", "Count to five.",
                     "What is two plus two?", "Name a planet."]
BATCH_PROMPTS = [f"Give me fact number {i} about the sea." for i in range(16)]


def _request(url: str, key: Optional[str] = None, body=None,
             method: Optional[str] = None, ctype: str = "application/json",
             cid: str = "") -> tuple:
    """(status, parsed JSON or raw bytes) of one call (``_post``'s
    arguments); an HTTP error is a status with no body, not an exception
    (the NaN-poisoned chat's 5xx)."""
    try:
        with _post(url, body, timeout=600, key=key, method=method,
                   ctype=ctype, cid=cid) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, None
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw


def _concurrent(fn, args: list) -> list:
    """``fn(*a)`` for each of ``args`` on threads of their own, in order."""
    out: list = [None] * len(args)
    errors: list = []

    def run(i, a):
        try:
            out[i] = fn(*a)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, a))
               for i, a in enumerate(args)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _upload_form(fields: dict, files: dict) -> tuple:
    """(content type, body) of a multipart/form-data upload."""
    boundary = "smoke" + os.urandom(8).hex()
    parts = []
    for name, value in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{name}"\r\n\r\n{value}\r\n'.encode())
    for name, (fname, data) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{name}"; filename="{fname}"\r\n'
                     'Content-Type: application/jsonl\r\n\r\n'.encode()
                     + data + b"\r\n")
    return (f"multipart/form-data; boundary={boundary}",
            b"".join(parts) + f"--{boundary}--\r\n".encode())


def phase_self_healing(srv, card: str, key: str) -> dict:
    """Self-healing and the batch lane on the served Qwen2.5-7B engine
    (after the observatory phase, on the same server and API key). The
    phase sets ``SELF_HEAL_ENV`` (a 2 s stall deadline, which the
    process-wide watchdog re-reads here, and the drain-time KV sweep),
    clears the SLO targets (the errors it causes on purpose must not shed
    its own requests) and arms every fault through ``POST /debug/faults``:

      1. NaN quarantine: four concurrent greedy 32-token chats, then the
         same four with ``decode.nan`` armed on one's correlation id: that
         chat ends in an error, the other three texts equal the unarmed
         ones, ``nan_rows`` is 1 and ``quarantined_slots`` 1 until the
         window of dispatches passes, and the hold the engine logged
         (poisoning to release, in dispatches) is at least that window;
         K1 launches once per layer a decode step;
      2. stall → rebuild: an ``engine.drain`` hang past the deadline under
         a streamed chat: the stream ends in an error, ``rebuilds`` is 1,
         the engine serves again, the next chat's greedy text equals its
         pre-fault text, the KV sweep saw 0 violations, and the old engine
         thread exits; the rebuild's wall, its probe's and the peak memory
         across it are printed;
      3. batch lane: 16 chat lines uploaded through ``/v1/files`` run as a
         batch while two streamed interactive chats run: the job completes,
         each line's text equals the same request served interactively,
         ``localai_batch_lines_total{result="completed"}`` reads 16; the
         job's wall, its lines/s and the interactive TTFT beside it are
         printed, and K1 launches once per layer a decode step.

    Prints one ``self_healing:`` line; every number stands beside the
    card's name and power limit."""
    from localai_tpu_torch.obs import slo as obs_slo
    from localai_tpu_torch.obs import watchdog as obs_watchdog

    t_phase = time.monotonic()
    url, name, sched = srv.server.url, srv.name, srv.sm.scheduler
    chat_url = url + "/v1/chat/completions"
    wd = obs_watchdog.WATCHDOG
    saved = {k: os.environ.get(k) for k in SELF_HEAL_ENV}
    saved_wd = (wd.deadline, wd.poll_interval)
    os.environ.update(SELF_HEAL_ENV)
    # the process-wide watchdog read the deadline when it was made: restart
    # its thread on the phase's setting
    wd.stop()
    wd.deadline = float(SELF_HEAL_ENV["LOCALAI_STALL_DEADLINE_S"])
    wd.poll_interval = max(0.25, wd.deadline / 4.0)
    wd.start()
    # the server's scheduler was built before the phase: the drill turns
    # its drain-time sweep on
    sched.kv_check = True
    obs_slo.SLO.configure(targets={})

    def body(prompt, n=32, **extra):
        return {"model": name, "max_tokens": n, "temperature": 0,
                "messages": [{"role": "user", "content": prompt}], **extra}

    def arm(spec):
        status, out = _request(url + "/debug/faults", key, spec)
        if status != 200 or out["armed"]["site"] != spec["site"]:
            raise AssertionError(f"arming {spec} answered {status} {out}")

    def text(res):
        return res[1]["choices"][0]["message"]["content"]

    try:
        sup = sched.supervisor
        if sup is None:
            raise AssertionError(f"{name}: no self-healing supervisor")
        # -- 1. NaN quarantine ---------------------------------------------
        cids = [f"self-heal-{i}" for i in range(len(SELF_HEAL_PROMPTS))]
        calls = [(chat_url, key, body(p), None, "application/json", c)
                 for p, c in zip(SELF_HEAL_PROMPTS, cids)]
        ref = _concurrent(_request, calls)
        if any(r[0] != 200 for r in ref):
            raise AssertionError(f"unarmed chats: {[r[0] for r in ref]}")
        arm({"site": "decode.nan", "mode": "nan", "match": cids[0],
             "times": 1})
        run = _counted(srv.sm, _all_kernels(),
                       lambda: _concurrent(_request, calls))
        armed = run.pop("result")
        m = sched.metrics()
        poisoned = armed[0]
        if not (poisoned[0] >= 500 or poisoned[1]["choices"][0][
                "finish_reason"] == "error"):
            raise AssertionError(f"the poisoned chat answered {poisoned}")
        others = [text(a) == text(r) for a, r in zip(armed[1:], ref[1:])]
        if not all(others) or any(a[0] != 200 for a in armed[1:]):
            raise AssertionError(f"co-batched chats changed: {others}")
        if m["nan_rows"] != 1 or m["quarantined_slots"] != 1:
            raise AssertionError(f"nan_rows {m['nan_rows']}, quarantined "
                                 f"{m['quarantined_slots']}")
        _check_k1(name, run, srv.sm.runner.cfg.num_layers)
        drains = 0
        while sched.metrics()["quarantined_slots"] and drains < 40:
            drains += 1
            if _request(chat_url, key, body("Say hello.", 16))[0] != 200:
                raise AssertionError("a chat failed in the quarantine")
        if sched.metrics()["quarantined_slots"]:
            raise AssertionError("the quarantined slot never came back")
        # the hold as the engine logged it: the dispatch sequence at the
        # poisoning and at the release
        _, poisoned_at, released_at = sched.quarantine_log[-1]
        window = int(os.environ.get("LOCALAI_NAN_QUARANTINE_DISPATCHES")
                     or 16)
        held = released_at - poisoned_at
        if held < window:
            raise AssertionError(f"the slot was held {held} dispatches, "
                                 f"not {window}")
        nan_rec = {"nan_rows": m["nan_rows"], "window_setting": window,
                   "poisoned_at_dispatch": poisoned_at,
                   "released_at_dispatch": released_at,
                   "held_dispatches": held,
                   "chats_to_release": drains, "launches": run,
                   "poisoned_status": poisoned[0]}
        print("self_healing nan: " + json.dumps({"card": card, **nan_rec}),
              flush=True)
        # -- 2. stall → rebuild ----------------------------------------------
        before = _request(chat_url, key, body("Say hello."))
        old_thread = sched._thread
        old_ptr = srv.sm.runner.kv.k.data_ptr()
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in (srv.sm.runner.kv.k, srv.sm.runner.kv.v))
        torch.cuda.synchronize()
        allocated_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stream: dict = {}

        def streamed():
            try:
                stream.update(_streamed_chat(
                    chat_url, body("Tell a long story.", 256,
                                   ignore_eos=True), key))
            except urllib.error.HTTPError as e:  # a 5xx before the stream
                stream["status"] = e.code

        th = threading.Thread(target=streamed)
        th.start()
        deadline = time.monotonic() + 60
        while not any(c.handle.t_first_token
                      for c in list(sched._slots.values())) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        t_arm = time.monotonic()
        arm({"site": "engine.drain", "mode": "hang", "delay_s": 6.0,
             "times": 1})
        th.join(120)
        deadline = time.monotonic() + 120
        while sched.rebuilds < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        t_rebuilt = time.monotonic()
        if stream.get("finish") != "error" and stream.get("status", 200) < 500:
            raise AssertionError(f"the in-flight chat ended {stream}")
        m = sched.metrics()
        if m["rebuilds"] != 1 or m["engine_state"] != "serving":
            raise AssertionError(f"rebuilds {m['rebuilds']}, state "
                                 f"{m['engine_state']}")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = _request(chat_url, key, body("Say hello."))
        if after[0] != 200 or text(after) != text(before):
            raise AssertionError(f"after the rebuild: {after} vs {before}")
        old_thread.join(30)
        if old_thread.is_alive():
            raise AssertionError("the fenced engine thread did not exit")
        if srv.sm.runner.kv.k.data_ptr() == old_ptr:
            raise AssertionError("the rebuilt pool reuses the old storage")
        _, kvdbg = _request(url + "/debug/kv", key)
        seen = kvdbg["models"][name]["violations_seen"]
        if m["kv_invariant_violations"] != 0 or seen != 0:
            raise AssertionError(f"KV sweep: {m['kv_invariant_violations']}"
                                 f" / {seen} violations")
        _, fstat = _request(url + "/debug/faults", key)
        rebuild_rec = {
            "rebuild_s": sched.last_rebuild_s,
            "probe_ms": sched.last_probe_s * 1e3,
            "stall_to_rebuilt_s": t_rebuilt - t_arm,
            "kv_pool_gb": kv_bytes / 1e9,
            "allocated_before_gb": allocated_before / 1e9,
            "peak_across_rebuild_gb": peak / 1e9,
            "peak_over_before_gb": (peak - allocated_before) / 1e9,
            "stream": {k: stream.get(k) for k in ("finish", "tokens",
                                                  "status")},
            "supervisor": fstat["supervisors"][name],
            "kv_violations": m["kv_invariant_violations"]}
        print("self_healing rebuild: " + json.dumps({"card": card, **rebuild_rec}),
              flush=True)
        # -- 3. batch lane ---------------------------------------------------
        inter = _concurrent(_request, [(chat_url, key, body(p))
                                       for p in BATCH_PROMPTS])
        if any(r[0] != 200 for r in inter):
            raise AssertionError("an interactive reference chat failed")
        lines = [json.dumps({"custom_id": f"line-{i}", "method": "POST",
                             "url": "/v1/chat/completions",
                             "body": body(p)})
                 for i, p in enumerate(BATCH_PROMPTS)]
        ctype, upload = _upload_form(
            {"purpose": "batch"},
            {"file": ("smoke.jsonl", ("\n".join(lines) + "\n").encode())})

        def batch_run():
            _, f = _request(url + "/v1/files", key, upload, ctype=ctype)
            t0 = time.monotonic()
            _, job = _request(url + "/v1/batches", key, {
                "endpoint": "/v1/chat/completions", "input_file_id": f["id"]})
            chats = _concurrent(_streamed_chat, [
                (chat_url, body(p, 64), key)
                for p in ("Describe a forest.", "Describe a river.")])
            while time.monotonic() - t0 < 300:
                _, job = _request(url + f"/v1/batches/{job['id']}", key)
                if job["status"] in ("completed", "failed", "cancelled",
                                     "expired"):
                    break
                time.sleep(0.1)
            return job, time.monotonic() - t0, chats

        run = _counted(srv.sm, _all_kernels(), batch_run)
        job, job_s, chats = run.pop("result")
        if job["status"] != "completed" or job["request_counts"] != {
                "total": 16, "completed": 16, "failed": 0}:
            raise AssertionError(f"batch job ended {job}")
        _, out = _request(url + f"/v1/files/{job['output_file_id']}/content",
                          key)
        recs = {r["custom_id"]: r for r in (
            json.loads(x) for x in out.decode().splitlines())}
        same = [recs[f"line-{i}"]["response"]["body"]["choices"][0][
            "message"]["content"] == text(inter[i]) for i in range(16)]
        if not all(same):
            raise AssertionError(f"batch texts differ from interactive: "
                                 f"{same}")
        if any(c.get("finish") not in ("stop", "length") for c in chats):
            raise AssertionError(f"interactive chats beside the job: {chats}")
        _, scrape, _ = _get(url + "/metrics", key)
        lines_ok = sum(float(x.rsplit(" ", 1)[1])
                       for x in scrape.decode().splitlines()
                       if x.startswith('localai_batch_lines_total{'
                                       'result="completed"}'))
        if lines_ok != 16:
            raise AssertionError(f"batch lines counted {lines_ok}")
        _check_k1(name, run, srv.sm.runner.cfg.num_layers)
        batch_rec = {"lines": 16, "job_wall_s": job_s,
                     "lines_per_s": 16 / job_s,
                     "tokens": sum(r["response"]["body"]["usage"][
                         "completion_tokens"] for r in recs.values()),
                     "interactive_ttft_s": [c["ttft_s"] for c in chats],
                     "interactive_tokens": [c["tokens"] for c in chats],
                     "launches": run}
        print("self_healing batch: " + json.dumps({"card": card, **batch_rec}),
              flush=True)
        rec = {"card": card, "model": name, "nan": nan_rec,
               "rebuild": rebuild_rec, "batch": batch_rec,
               "phase_s": time.monotonic() - t_phase}
        print("self_healing: " + json.dumps(rec), flush=True)
        return rec
    finally:
        _request(url + "/debug/faults", key, method="DELETE")
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        wd.stop()
        wd.deadline, wd.poll_interval = saved_wd
        wd.start()
        sched.kv_check = False


def phase_serve_qwen(card: str) -> dict:
    """``qwen2.5-7b-bf16``, the group-7 serve: a checkpoint directory with
    Qwen2.5-7B-Instruct's config.json (full widths, 28 query / 4 kv
    heads; the depth of ``SMOKE_LAYERS``), seeded random bf16 weights drawn on the card and written
    once by ``models.loader.write_llama_checkpoint``, and the smoke's
    128256-id tokenizer.json; loaded from a YAML naming the directory,
    paged, ``spec: false``, served with one API key, loose SLO targets (no
    shedding), history and profiles under temp dirs. A warm-up chat, then
    five greedy 32-token chats (one streamed) with every count at 0: K1
    once per layer a plain decode step and no other kernel; then
    ``phase_telemetry`` and ``phase_observatory``. Returns the launches,
    the serve's record, the telemetry's and the observatory's."""
    import pathlib

    from localai_tpu_torch.models.llama import LlamaConfig, init_params
    from localai_tpu_torch.obs import compile as obs_compile
    from localai_tpu_torch.obs import history as obs_history

    root = pathlib.Path(_scratch_dir("qwen-serve-", 7_000_000_000))
    ckpt, models = root / "Qwen2.5-7B-Instruct", root / "models"
    dirs = {"history": str(root / "history"),
            "profiles": str(root / "profiles"),
            "assets": str(root / "assets"),
            "uploads": str(root / "uploads")}
    env = {**OBSERVATORY_ENV, "LOCALAI_HISTORY_DIR": dirs["history"],
           "LOCALAI_PROFILE_DIR": dirs["profiles"]}
    saved = {k: os.environ.get(k) for k in env}
    try:
        hf = {**QWEN25_7B_CONFIG,
              "num_hidden_layers": SMOKE_LAYERS["qwen"]}
        cfg = LlamaConfig.from_hf(hf)  # bfloat16
        t0 = time.monotonic()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(17), "cuda")
        torch.cuda.synchronize()
        draw_s = time.monotonic() - t0
        written = write_checkpoint_dir(ckpt, cfg, params, "bfloat16", hf)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        size = sum(f.stat().st_size for f in ckpt.iterdir())
        print(f"checkpoint {QWEN}: {size / 1e9:.2f} GB written in "
              f"{written['weights_s']:.1f}s (weights drawn on the card in "
              f"{draw_s:.1f}s); card {card}", flush=True)
        models.mkdir()
        doc = {"name": QWEN, "model": str(ckpt), "context_size": 4096,
               "engine": {"max_slots": 8, "kv_block_tokens": 64,
                          "spec": False}}
        os.environ.update(env)
        # the catalog is process-wide: this serve's programs alone
        obs_compile.CATALOG.reset()
        with _Served(doc, models_path=str(models), app={
                "api_keys": [QWEN_KEY], "slo_ttft_p95_ms": 600_000.0,
                "slo_e2e_p95_ms": 600_000.0,
                "backend_assets_path": dirs["assets"],
                "upload_path": dirs["uploads"],
                "batch_concurrency": 6}) as srv:
            r = srv.sm.runner
            if (r.cfg.num_heads, r.cfg.num_kv_heads, r.cfg.num_layers) != (
                    28, 4, cfg.num_layers) or not r.paged or \
                    r.paged_attn_impl != \
                    "kernel" or srv.sm.scheduler.spec is not None:
                raise AssertionError(f"{QWEN}: not a paged group-7 engine "
                                     "on the kernels without speculation")
            warm = _chats(srv.chat, srv.name, n=1, key=QWEN_KEY)
            torch.cuda.reset_peak_memory_stats()
            run = _counted(srv.sm, _all_kernels(),
                           lambda: _chats(srv.chat, srv.name, key=QWEN_KEY))
            chats = run.pop("result")
            rec = {"card": card, "model": QWEN, "checkpoint_gb": size / 1e9,
                   "checkpoint_write_s": written["weights_s"],
                   "load_s": srv.load_s, "requests": 5, "streaming": 1,
                   "completion_tokens": chats["tokens"],
                   "wall_s": chats["wall_s"],
                   "tokens_per_s": chats["tokens"] / chats["wall_s"],
                   "ttft_stream_s": chats["ttft_s"], "launches": run,
                   "max_memory_allocated_gb":
                       torch.cuda.max_memory_allocated() / 1e9}
            print("serve: " + json.dumps(rec), flush=True)
            _check_k1(QWEN, run, cfg.num_layers)
            tele = phase_telemetry(srv, [warm, chats], key=QWEN_KEY)
            t_obs = time.monotonic()
            obs = phase_observatory(srv, [warm, chats], QWEN_KEY, dirs)
            print(f"observatory phase: {time.monotonic() - t_obs:.1f}s",
                  flush=True)
            t_heal = time.monotonic()
            heal = phase_self_healing(srv, card, QWEN_KEY)
            print(f"self-healing phase: {time.monotonic() - t_heal:.1f}s",
                  flush=True)
        return {"launches": run, "serve": rec, "telemetry": tele,
                "observatory": obs, "self_healing": heal}
    finally:
        # the history writer stops with the serve; later servers start
        # without this phase's settings
        obs_history.HISTORY.stop()
        obs_history.HISTORY.configure(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_kernel_llava() -> dict:
    """K1, K2 and K3 at Llama-2-7B's shape (Hq = Hkv = 32, a GQA group of
    1, hd 128, 8 slots, bf16), each against its plain version and timed
    beside SDPA, with the plan it takes: K1 over 64-entry tables at
    positions 63-4095, K2 over a 4096-row cache, K3 at T = 640 and 2048
    and at the contiguous LLaVA serve's shape (a 2048 bucket holding a
    ~640-token image prompt)."""
    g1 = {"Hq": 32, "Hkv": 32, "hd": 128}
    return {
        "k1": kernel_case("llava-g1-bf16", torch.bfloat16, timed=True,
                          seed=60, **g1),
        "k2": decode_case("k2-llava-g1-bf16", torch.bfloat16, timed=True,
                          seed=61, **g1),
        "k3-T640": prefill_case("k3-llava-g1-T640-bf16", torch.bfloat16,
                                640, seed=62, **g1),
        "k3-T2048": prefill_case("k3-llava-g1-T2048-bf16", torch.bfloat16,
                                 2048, seed=63, **g1),
        "k3-served": prefill_case("k3-llava-g1-T2048-len640-bf16",
                                  torch.bfloat16, 2048, length=640, seed=64,
                                  **g1),
    }


LLAVA_CHATS = [  # (text, image fixtures, video fixture), one streamed
    ("Describe this photo.", ["photo.jpg"], None),
    ("What colours are in this picture?", ["progressive.jpg"], None),
    ("Is there transparency in this image?", ["rgba.png"], None),
    ("What moves in this clip?", [], "video.gif"),
    ("Say hello in three languages.", [], None),
]


def _llava_body(i: int, max_tokens: int = 32, stream: bool = False) -> dict:
    text, imgs, vid = LLAVA_CHATS[i]
    parts = [{"type": "text", "text": text}]
    parts += [{"type": "image_url", "image_url": {"url": _data_uri(n)}}
              for n in imgs]
    if vid:
        parts.append({"type": "video_url",
                      "video_url": {"url": _data_uri(vid)}})
    return {"model": LLAVA, "max_tokens": max_tokens, "temperature": 0,
            "stream": stream, "ignore_eos": True,
            "messages": [{"role": "user", "content": parts if imgs or vid
                          else text}]}


def _llava_chats(url: str, which: list[int], streamed: int) -> dict:
    """The LLaVA chats ``which`` concurrently, ``streamed`` among them
    streamed: {"tokens", "wall_s", "ttft_s", "texts"}."""
    results, errors = {}, []

    def run(i):
        try:
            if i != streamed:
                results[i] = json.loads(_post(url, _llava_body(i)).read())
                return
            t = time.monotonic()
            ttft, text, last = None, "", None
            with _post(url, _llava_body(i, stream=True)) as r:
                for line in r:
                    line = line.strip()
                    if not line.startswith(b"data: {"):
                        continue
                    frame = json.loads(line[6:])
                    delta = frame["choices"][0]["delta"].get("content")
                    if delta and ttft is None:
                        ttft = time.monotonic() - t
                    text += delta or ""
                    last = frame
            results[i] = {"ttft_s": ttft, "text": text, "last": last}
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in which]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    ntok = 0
    for i in which:
        usage = (results[i]["last"] if i == streamed
                 else results[i])["usage"]
        if usage["completion_tokens"] <= 0:
            raise AssertionError(f"{LLAVA}: chat {i} returned no tokens")
        ntok += usage["completion_tokens"]
    return {"tokens": ntok, "wall_s": wall,
            "ttft_s": results[streamed]["ttft_s"] if streamed in results
            else None,
            "texts": {i: results[i]["text"] if i == streamed else
                      results[i]["choices"][0]["message"]["content"]
                      for i in which}}


def _count_calls(obj, name: str) -> list:
    """Record each call of ``obj.name`` (an instance attribute wrapping
    the method, dropped with the instance); returns the record."""
    calls: list = []
    method = getattr(type(obj), name)

    def counted(*a, **k):
        calls.append(1)
        return method(obj, *a, **k)

    setattr(obj, name, counted)
    return calls


def _ttft_parts(sm) -> dict:
    """The first image chat's time to first token, part by part, on an
    idle engine: fetch + decode of its data URI and preprocess (host ms),
    the tower's encode and the multimodal prefill (CUDA events around
    each; the prefill is a paged or contiguous ``admit`` of the expanded
    prompt on a free slot, its first token fetched)."""
    from localai_tpu_torch.api.inference import (
        MMContent,
        expand_image_placeholders,
    )
    from localai_tpu_torch.models import vision
    from localai_tpu_torch.utils import media

    text, imgs, _ = LLAVA_CHATS[0]
    t0 = time.perf_counter()
    img = media.fetch_image(_data_uri(imgs[0]))
    fetch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = torch.from_numpy(vision.preprocess([img], sm.vision.cfg))
    pre_ms = (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        x = batch.to("cuda")
        a.record()
        emb = vision.forward(sm.vision.cfg, sm.vision.params, x)
        b.record()
        emb = emb.float().cpu().numpy()
    torch.cuda.synchronize()
    encode_ms = a.elapsed_time(b)
    ids, rows, pos = expand_image_placeholders(
        sm, f"<user>{text} [img-0]\n<assistant>",
        MMContent(embeds=emb, video_groups=[]))
    r = sm.runner
    s = r.acquire_slot()
    t0 = time.perf_counter()
    a.record()
    r.admit(s, ids, temperature=0.0, mm_embeds=rows, mm_positions=pos,
            reserve_tokens=len(ids) + 8)
    b.record()
    torch.cuda.synchronize()
    prefill_wall = (time.perf_counter() - t0) * 1e3
    r.release(s)
    return {"fetch_decode_ms": fetch_ms, "preprocess_ms": pre_ms,
            "encode_ms": encode_ms, "mm_prefill_ms": a.elapsed_time(b),
            "mm_prefill_wall_ms": prefill_wall, "prompt_ids": len(ids),
            "path": r.last_prefill_path}


def phase_serve_llava(card: str) -> dict:
    """The LLaVA serve, ``llava-1.5-7b-bf16``: LLaVA-1.5-7B's published
    widths and depth (LLAVA_15_7B_CONFIG) with bf16 weights drawn on the
    card, the language model in the engine ``build_serving_model`` makes
    of the default config (paged pool, 8 slots, ctx 4096, n-gram
    speculation on) with the CLIP tower and projector beside it, served
    over HTTP: five greedy 32-token chats, one streamed, carrying the
    JPEG, the progressive JPEG, the RGBA PNG, the GIF as a video_url, and
    none. Then the same weights on a contiguous engine: two image chats.
    Asserts K1 = 32 per paged decode step, K3 = 32 per contiguous
    (multimodal) prefill and K2 = 32 per contiguous decode step exactly,
    the image chats through the multimodal prefill, peak memory under
    80 GB. Returns the launches of both engines."""
    import dataclasses

    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.engine.scheduler import Scheduler
    from localai_tpu_torch.models import vision
    from localai_tpu_torch.models.llama import LlamaConfig, init_params
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )

    wrappers = {"paged_decode_attention": paged_decode_attention,
                "decode_attention": decode_attention,
                "prefill_attention": prefill_attention}
    hf = LLAVA_15_7B_CONFIG
    cfg = dataclasses.replace(LlamaConfig.from_hf(hf["text_config"]),
                              dtype="bfloat16")
    vcfg = dataclasses.replace(vision.VisionConfig.from_hf(
        hf["vision_config"], projection_dim=cfg.hidden_size,
        feature_layer=hf["vision_feature_layer"]), dtype="bfloat16")
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    vparams = vision.init_params(vcfg, gen, "cuda")
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    wb = {"text": nbytes(params),
          "tower": nbytes(vparams) - nbytes(vparams["projector"]),
          "projector": nbytes(vparams["projector"])}
    print(f"serve {LLAVA}: bf16 weights drawn on the card in {draw_s:.1f}s"
          f": {json.dumps({k: v / 1e9 for k, v in wb.items()})} GB "
          "(reckoned: 13.48 text + 0.61 tower + 0.04 projector)",
          flush=True)
    mcfg = ModelConfig.from_dict({
        "name": LLAVA, "model": "llava-hf/llava-1.5-7b-hf",
        "context_size": 4096,
        "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                   "max_slots": 8, "kv_block_tokens": 64}})
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    app = AppConfig(device="cuda")
    tower = vision.VisionTower(vcfg, vparams, "cuda")
    out = {}
    sm = manager = server = None
    try:
        sm = _synthetic_serving_model(mcfg, app, cfg, params)
        sm.vision, sm.image_token_id = tower, hf["image_token_index"]
        if sm.scheduler.spec is None or not sm.runner.paged:
            raise AssertionError(f"{LLAVA}: not paged with speculation")
        mm_prefills = _count_calls(sm.runner, "_prefill_paged_mm_fn")
        manager = _one_model_manager(app, loader, sm)
        server = APIServer(manager, "127.0.0.1", 0).start()
        chat = server.url + "/v1/chat/completions"
        json.loads(_post(chat, _llava_body(0, max_tokens=2)).read())
        mm_prefills.clear()
        run = _counted(sm, wrappers, lambda: _llava_chats(
            chat, list(range(5)), streamed=0))
        res = run.pop("result")
        n_mm = len(mm_prefills)
        parts = _ttft_parts(sm)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print("serve: " + json.dumps({
            "card": card, "model": LLAVA, "weights": "bfloat16",
            "weight_gb": {k: v / 1e9 for k, v in wb.items()},
            "kv_dtype": "bfloat16", "kv_layout": "paged", "requests": 5,
            "streaming": 1, "image_chats": 3, "video_chats": 1,
            "mm_prefills": n_mm,
            "completion_tokens": res["tokens"], "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens"] / res["wall_s"],
            "ttft_stream_s": res["ttft_s"], "ttft_parts": parts,
            "max_memory_allocated_gb": peak, **run,
            **{k: v for k, v in sm.scheduler.metrics().items()
               if k.startswith("spec_")}}, default=str), flush=True)
        if (run["paged_decode_attention"] != L * run["decode_steps"]
                or run["decode_steps"] <= 0 or run["decode_attention"]
                or run["prefill_attention"]):
            raise AssertionError(f"{LLAVA}: launches {run}, expected K1 = "
                                 f"{L} x {run['decode_steps']} steps only")
        if n_mm != 4:
            raise AssertionError(f"{LLAVA}: {n_mm} multimodal "
                                 "prefills, expected 4 (3 images, 1 video)")
        if parts["path"] != "paged_mm":
            raise AssertionError(f"{LLAVA}: prefill path {parts['path']}")
        if not peak < 80:
            raise AssertionError(f"{LLAVA}: peak memory {peak} GB")
        out["paged"] = run
    finally:
        if server is not None:
            server.shutdown()
        if manager is not None:
            manager.shutdown()
        elif sm is not None:
            sm.close()
        sm = manager = server = None
        gc.collect()
        torch.cuda.empty_cache()
    # the same weights on a contiguous engine: K3 prefills the image
    # prompt in one dispatch, K2 decodes
    from localai_tpu_torch.models.manager import ServingModel
    from localai_tpu_torch.templates.cache import TemplateCache
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    eng = mcfg.engine
    left = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    try:
        runner = ModelRunner(cfg, params, num_slots=eng.max_slots,
                             max_ctx=4096, kv_dtype="bfloat16", paged=False,
                             prefill_buckets=eng.prefill_buckets,
                             device="cuda")
        tok = ByteTokenizer()
        sm = ServingModel(
            name=LLAVA, config=mcfg, runner=runner, tokenizer=tok,
            scheduler=Scheduler(runner, tok, multi_step=
                                eng.decode_steps_per_dispatch,
                                pipeline_depth=eng.pipeline_depth),
            templates=TemplateCache(app.model_path), vision=tower,
            image_token_id=hf["image_token_index"])
        manager = _one_model_manager(app, loader, sm)
        server = APIServer(manager, "127.0.0.1", 0).start()
        chat = server.url + "/v1/chat/completions"
        json.loads(_post(chat, _llava_body(2, max_tokens=2)).read())
        before = runner.fresh_prefills
        run = _counted(sm, wrappers, lambda: _llava_chats(
            chat, [0, 1], streamed=1))
        res = run.pop("result")
        prefills = runner.fresh_prefills - before
        parts = _ttft_parts(sm)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print("serve: " + json.dumps({
            "card": card, "model": LLAVA, "kv_layout": "contiguous",
            "requests": 2, "image_chats": 2, "fresh_prefills": prefills,
            "completion_tokens": res["tokens"], "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens"] / res["wall_s"],
            "ttft_stream_s": res["ttft_s"], "ttft_parts": parts,
            "allocated_before_gb": left, "max_memory_allocated_gb": peak,
            **run}, default=str), flush=True)
        if (prefills != 2 or run["prefill_attention"] != L * prefills
                or run["decode_attention"] != L * run["decode_steps"]
                or run["decode_steps"] <= 0
                or run["paged_decode_attention"]):
            raise AssertionError(f"{LLAVA} contiguous: launches {run}, "
                                 f"{prefills} prefills")
        if parts["path"] != "mm":
            raise AssertionError(f"{LLAVA}: prefill path {parts['path']}")
        if not peak < 80:
            raise AssertionError(f"{LLAVA}: peak memory {peak} GB")
        out["contiguous"] = run
    finally:
        if server is not None:
            server.shutdown()
        if manager is not None:
            manager.shutdown()
        elif sm is not None:
            sm.close()
        sm = manager = server = runner = tower = None
        del params, vparams
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# GGUF files (the gguf_convert phase; tests/test_torch_gguf.py writes its
# fixtures with the same functions)
# ---------------------------------------------------------------------------

GGUF_F32, GGUF_F16, GGUF_Q4_0, GGUF_Q4_1, GGUF_Q8_0 = 0, 1, 2, 3, 8
GGUF_Q4_K, GGUF_Q6_K = 12, 14
# ggml type → (elements, bytes) a block
GGUF_BLOCK = {GGUF_F32: (1, 4), GGUF_F16: (1, 2), GGUF_Q4_0: (32, 18),
              GGUF_Q4_1: (32, 20), GGUF_Q8_0: (32, 34),
              GGUF_Q4_K: (256, 144), GGUF_Q6_K: (256, 210)}
# the f16 fields of a block (byte offset → range of the random value):
# scales sized so the dequantized weights are of order 0.02 (q4_k: d * 63
# * 15 and dmin * 63; q6_k: d * 127 * 32; q8_0: d * 127; q4_0: d * 8)
_GGUF_F16_FIELDS = {GGUF_Q4_0: {0: (1e-3, 4e-3)},
                    GGUF_Q4_1: {0: (1e-3, 4e-3), 2: (-1e-2, 0.0)},
                    GGUF_Q8_0: {0: (1e-4, 3e-4)},
                    GGUF_Q4_K: {0: (1e-5, 3e-5), 2: (1e-5, 3e-5)},
                    GGUF_Q6_K: {208: (3e-6, 6e-6)}}


def gguf_random_blocks(rng, n: int, dt: int) -> bytes:
    """``n`` elements in ggml type ``dt``: random block bytes whose f16
    scale fields hold finite values (f32 / f16: N(0, 0.02))."""
    if dt == GGUF_F32:
        return (rng.standard_normal(n, dtype=np.float32) * 0.02).tobytes()
    if dt == GGUF_F16:
        return (rng.standard_normal(n) * 0.02).astype(np.float16).tobytes()
    per, nbytes = GGUF_BLOCK[dt]
    b = rng.integers(0, 256, (n // per, nbytes), dtype=np.uint8)
    for off, (lo, hi) in _GGUF_F16_FIELDS[dt].items():
        b[:, off:off + 2] = rng.uniform(lo, hi, (n // per, 1)).astype(
            np.float16).view(np.uint8)
    return b.tobytes()


def _gguf_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _gguf_kv(key: str, vtype: int, value) -> bytes:
    out = _gguf_str(key) + struct.pack("<I", vtype)
    if vtype == 4:      # u32
        return out + struct.pack("<I", value)
    if vtype == 6:      # f32
        return out + struct.pack("<f", value)
    if vtype == 8:      # string
        return out + _gguf_str(value)
    if vtype == 9:      # array of strings
        return out + struct.pack("<IQ", 8, len(value)) + b"".join(
            _gguf_str(v) for v in value)
    raise ValueError(f"GGUF metadata type {vtype}")


def write_gguf(path, metadata: list, tensors: list, seed: int = 0) -> int:
    """Write a GGUF v3 file (alignment 32): ``metadata`` [(key, type,
    value)] (u32 4, f32 6, string 8, string array 9), ``tensors`` [(name,
    shape, ggml type, data)] in file order, ``data`` the tensor's bytes or
    None for :func:`gguf_random_blocks` from ``seed``. Tensors are written
    one at a time. Returns the file's bytes."""
    rng = np.random.default_rng(seed)
    infos, off, sizes = b"", 0, []
    for name, shape, dt, _data in tensors:
        per, nbytes = GGUF_BLOCK[dt]
        n = int(np.prod(shape, dtype=np.int64))
        if n % per:
            raise ValueError(f"{name}: {n} elements in blocks of {per}")
        size = n // per * nbytes
        dims = list(reversed(shape))  # ggml ne[]: innermost first
        infos += _gguf_str(name) + struct.pack("<I", len(dims))
        infos += b"".join(struct.pack("<Q", d) for d in dims)
        infos += struct.pack("<IQ", dt, off)
        off += size + (-size) % 32
        sizes.append((n, size))
    body = (b"GGUF" + struct.pack("<IQQ", 3, len(tensors), len(metadata))
            + b"".join(_gguf_kv(*m) for m in metadata) + infos)
    total = 0
    with open(path, "wb") as f:
        total += f.write(body + b"\0" * ((-len(body)) % 32))
        for (name, shape, dt, data), (n, size) in zip(tensors, sizes):
            if data is None:
                data = gguf_random_blocks(rng, n, dt)
            if len(data) != size:
                raise ValueError(f"{name}: {len(data)} bytes, want {size}")
            total += f.write(data + b"\0" * ((-size) % 32))
    return total


GGUF_MODEL = "mixtral-gguf-int8"


def mixtral_gguf_spec(layers: int = 2) -> tuple[list, list]:
    """(metadata, tensors) of a GGUF at Mixtral-8x7B's widths with
    ``layers`` layers in llama.cpp's Q4_K_M mix: token_embd and the
    attention q/k/output Q4_K, attn_v Q8_0, the experts' gate/up Q4_K
    and down Q6_K, output Q6_K, f32 norms of ones and an f32 router;
    every quantized block random with finite f16 scales. The vocabulary
    is 32000 pieces (<unk>, <s>, </s>, then words)."""
    c = MIXTRAL_8X7B_CONFIG
    D, F, E = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    H, HKV, V = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["vocab_size"])
    hd = D // H
    ones = np.ones(D, np.float32).tobytes()
    tensors = [("token_embd.weight", (V, D), GGUF_Q4_K, None),
               ("output_norm.weight", (D,), GGUF_F32, ones),
               ("output.weight", (V, D), GGUF_Q6_K, None)]
    for i in range(layers):
        b = f"blk.{i}."
        tensors += [
            (b + "attn_norm.weight", (D,), GGUF_F32, ones),
            (b + "attn_q.weight", (H * hd, D), GGUF_Q4_K, None),
            (b + "attn_k.weight", (HKV * hd, D), GGUF_Q4_K, None),
            (b + "attn_v.weight", (HKV * hd, D), GGUF_Q8_0, None),
            (b + "attn_output.weight", (D, H * hd), GGUF_Q4_K, None),
            (b + "ffn_norm.weight", (D,), GGUF_F32, ones),
            (b + "ffn_gate_inp.weight", (E, D), GGUF_F32, None),
            (b + "ffn_gate_exps.weight", (E, F, D), GGUF_Q4_K, None),
            (b + "ffn_up_exps.weight", (E, F, D), GGUF_Q4_K, None),
            (b + "ffn_down_exps.weight", (E, D, F), GGUF_Q6_K, None)]
    words = ["<unk>", "<s>", "</s>"] + [f"w{i}" for i in range(V - 3)]
    meta = [("general.architecture", 8, "llama"),
            ("general.name", 8, "mixtral-8x7b-instruct (random blocks)"),
            ("llama.vocab_size", 4, V),
            ("llama.embedding_length", 4, D),
            ("llama.feed_forward_length", 4, F),
            ("llama.block_count", 4, layers),
            ("llama.attention.head_count", 4, H),
            ("llama.attention.head_count_kv", 4, HKV),
            ("llama.expert_count", 4, E),
            ("llama.expert_used_count", 4, c["num_experts_per_tok"]),
            ("llama.context_length", 4, c["max_position_embeddings"]),
            ("llama.rope.freq_base", 6, c["rope_theta"]),
            ("llama.attention.layer_norm_rms_epsilon", 6, c["rms_norm_eps"]),
            ("tokenizer.ggml.tokens", 9, words),
            ("tokenizer.ggml.bos_token_id", 4, 1),
            ("tokenizer.ggml.eos_token_id", 4, 2)]
    return meta, tensors


def phase_gguf_convert(card: str) -> dict:
    """A GGUF at Mixtral-8x7B's widths (``SMOKE_LAYERS`` deep, Q4_K_M
    mix) written here, converted by ``util convert`` in a subprocess of the real
    entry point, then served from a one-line YAML with ``quantization:
    int8`` (quantized layer by layer as the checkpoint is read) through
    ``cli.main.build_server``: two greedy chats, the converted WordLevel
    tokenizer, K1 2 per decode step and the expert grid 3 per layer.
    Prints the GGUF's bytes, the convert and load seconds and the bf16
    bytes written. Returns the launch counts."""
    import os
    import pathlib

    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.models.quant import QuantizedTensor
    from localai_tpu_torch.ops.attention import paged_decode_attention
    from localai_tpu_torch.ops.qmatmul import w8_matmul, w8_matmul_experts

    root = pathlib.Path(_scratch_dir("gguf-", 10_000_000_000))
    src = root / "mixtral-8x7b-instruct.Q4_K_M.gguf"
    out, models = root / "mixtral-8x7b-instruct", root / "models"
    saved_env = {k: os.environ.get(k) for k in (
        "LOCALAI_MODELS_PATH", "LOCALAI_ADDRESS", "LOCALAI_PORT",
        "LOCALAI_CONFIG_PATH")}
    server = None
    try:
        meta, tensors = mixtral_gguf_spec(SMOKE_LAYERS["gguf"])
        t0 = time.monotonic()
        gguf_bytes = write_gguf(src, meta, tensors, seed=1)
        write_s = time.monotonic() - t0
        repo = pathlib.Path(__file__).resolve().parent
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "localai_tpu_torch.cli.main", "util",
             "convert", str(src), str(out)], cwd=repo, capture_output=True,
            text=True, timeout=900,
            env={**os.environ, "PYTHONPATH": str(repo)})
        convert_s = time.monotonic() - t0
        if res.returncode != 0 or "converted" not in res.stdout:
            raise AssertionError(f"util convert: rc {res.returncode}\n"
                                 f"{res.stdout}\n{res.stderr[-4000:]}")
        written = (out / "model.safetensors").stat().st_size
        src.unlink()
        models.mkdir()
        (models / f"{GGUF_MODEL}.yaml").write_text(
            f"{{model: {out}, context_size: 2048, engine: "
            "{quantization: int8, max_slots: 8}}\n")
        os.environ.update({
            "LOCALAI_MODELS_PATH": str(models),
            "LOCALAI_ADDRESS": "127.0.0.1", "LOCALAI_PORT": "0",
            "LOCALAI_CONFIG_PATH": str(root / "configuration")})
        server = build_server(["run"]).start()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        sm = server.manager.get(GGUF_MODEL)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        cfg = sm.runner.cfg
        lay = sm.runner.params["layers"]
        c = MIXTRAL_8X7B_CONFIG
        want = (SMOKE_LAYERS["gguf"], c["num_local_experts"],
                c["hidden_size"],
                c["intermediate_size"])
        if ((cfg.num_layers, cfg.num_experts, cfg.hidden_size,
             cfg.intermediate_size) != want
                or not isinstance(lay["w_up"], QuantizedTensor)
                or tuple(lay["w_up"].q.shape) != want
                or type(sm.tokenizer).__name__ != "HFTokenizer"):
            raise AssertionError(f"{GGUF_MODEL}: not the converted Mixtral "
                                 f"served in int8: {cfg}")
        print(f"gguf {GGUF_MODEL}: {gguf_bytes / 1e9:.3f} GB GGUF written "
              f"in {write_s:.1f}s, converted by util convert in "
              f"{convert_s:.1f}s to {written / 1e9:.3f} GB of bf16, loaded "
              f"(int8 on load) in {load_s:.1f}s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB over "
              f"{base:.2f} GB allocated before; card {card}", flush=True)
        wrappers = {"paged_decode_attention": paged_decode_attention,
                    "w8_matmul": w8_matmul,
                    "w8_matmul_experts": w8_matmul_experts,
                    "w8_matmul_experts_up": w8_matmul_experts.up,
                    "w8_matmul_experts_down": w8_matmul_experts.down}
        run = _counted(sm, wrappers, lambda: _chats(
            server.url + "/v1/chat/completions", GGUF_MODEL, n=2,
            max_tokens=16))
        res = run.pop("result")
        L = cfg.num_layers
        dispatches = (run["decode_steps"] + run["verify_windows"]
                      + run["prefill_chunks"])
        texts = [res["results"][0]["choices"][0]["message"]["content"],
                 res["results"][1]["text"]]
        print(f"gguf {GGUF_MODEL}: 2 chats, {res['tokens']} tokens in "
              f"{res['wall_s']:.2f}s: {json.dumps(run)}; texts "
              f"{json.dumps([t[:80] for t in texts])}", flush=True)
        if (run["paged_decode_attention"] != L * run["decode_steps"]
                or run["w8_matmul_experts_up"] != 2 * L * dispatches
                or run["w8_matmul_experts_down"] != L * dispatches
                or run["decode_steps"] <= 0):
            raise AssertionError(f"{GGUF_MODEL}: launches {run}")
        return {"gguf_bytes": gguf_bytes, "convert_s": convert_s,
                "load_s": load_s, "bf16_bytes": written, **run}
    finally:
        if server is not None:
            server.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        server = sm = lay = None
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the rest of the text families: Mamba and RWKV on the recurrent-state
# engine, the BERT cross-encoder and sentence encoder
# ---------------------------------------------------------------------------

# state-spaces/mamba-2.8b-hf's published config.json (its widths)
MAMBA_28B_CONFIG = {
    "architectures": ["MambaForCausalLM"], "model_type": "mamba",
    "vocab_size": 50280, "hidden_size": 2560, "intermediate_size": 5120,
    "num_hidden_layers": 64, "state_size": 16, "conv_kernel": 4,
    "time_step_rank": 160, "use_bias": False, "use_conv_bias": True,
    "layer_norm_epsilon": 1e-5, "tie_word_embeddings": True,
    "bos_token_id": 0, "eos_token_id": 0, "pad_token_id": 0,
    "torch_dtype": "float32"}
# RWKV/rwkv-4-7b-pile's published config.json (its widths)
RWKV_4_7B_CONFIG = {
    "architectures": ["RwkvForCausalLM"], "model_type": "rwkv",
    "vocab_size": 50277, "hidden_size": 4096, "attention_hidden_size": 4096,
    "intermediate_size": 16384, "num_hidden_layers": 32,
    "layer_norm_epsilon": 1e-5, "context_length": 1024, "rescale_every": 6,
    "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0}
# cross-encoder/ms-marco-MiniLM-L-6-v2's published config.json
MINILM_L6_CE_CONFIG = {
    "architectures": ["BertForSequenceClassification"], "model_type": "bert",
    "vocab_size": 30522, "hidden_size": 384, "intermediate_size": 1536,
    "num_hidden_layers": 6, "num_attention_heads": 12,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "pad_token_id": 0, "hidden_act": "gelu",
    "id2label": {"0": "LABEL_0"}, "label2id": {"LABEL_0": 0}}
# BAAI/bge-large-en-v1.5's published config.json
BGE_LARGE_CONFIG = {
    "architectures": ["BertModel"], "model_type": "bert",
    "vocab_size": 30522, "hidden_size": 1024, "intermediate_size": 4096,
    "num_hidden_layers": 24, "num_attention_heads": 16,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "pad_token_id": 0, "hidden_act": "gelu"}
MAMBA = "mamba-2.8b-bf16"
RWKV = "rwkv-4-7b-bf16"
# depths cut to keep the smoke inside its 1200 s (the widths stay the
# published ones): the recurrent serves' loop prefills, the sentence
# encoder's CPU reference and the GGUF's conversion on the host scale
# with them; whisper-large-v3 (32 + 32 layers), the Qwen2.5-7B serve
# (28) and the Llama-3-8B checkpoint serve (32) were cut when the FLUX.1-dev
# serve joined the image group: their checkpoints' writes and loads and
# their host-bound decode steps scale with the depth. Halving them again
# when the tensor-parallel phase joined broke checks that hold bf16 greedy
# texts equal across engines (4-layer fleets: a routed text parted from
# the single engine's; the 4-layer checkpoint: the gallery's bt-32 ids
# parted from the by-path ones) and the Qwen serve's self-healing check
# (no released quarantine at 4 layers), so the depths stayed
SMOKE_LAYERS = {"mamba": 16, "rwkv": 8, "bge-large": 6, "gguf": 1,
                "whisper": 8, "qwen": 8, "checkpoint": 8, "fleet": 8}
RERANKER = "ms-marco-minilm-l6-f32"
EMBEDDER = "bge-large-en-v1.5-f32"
# the special tokens of bert-base-uncased's vocab.txt, at their ids
BERT_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
                 "[MASK]": 103}
BERT_VOCAB = 30522


def _corpus_words() -> list:
    """The lowercased words of ``TOKENIZER_CORPUS`` in order of first use
    (punctuation split off, as BertPreTokenizer splits it)."""
    seen: dict = {}
    for w in re.findall(r"[A-Za-z]+|[^\sA-Za-z]", TOKENIZER_CORPUS.lower()):
        seen.setdefault(w, None)
    return list(seen)


def bert_tokenizer_spec() -> dict:
    """A bert-base-uncased-shaped ``tokenizer.json`` (as a dict) of 30522
    ids: [PAD] 0, [unused0..98], [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
    103, [unused99..], then every printable ASCII and Latin-1 character,
    the same with the ``##`` prefix, the words of ``TOKENIZER_CORPUS``,
    and two- and three-letter pieces (bare and ``##``) up to the size;
    BertNormalizer
    (lowercase, strip accents), BertPreTokenizer, WordPiece with its
    decoder."""
    ids = {i: t for t, i in BERT_SPECIALS.items()}
    vocab = {ids.get(i, f"[unused{i - 1 if i < 100 else i - 5}]"): i
             for i in range(999)}
    chars = [chr(c) for c in range(33, 127)] + [
        chr(c) for c in range(0xA1, 0x100) if chr(c).isprintable()]
    pieces = chars + ["##" + c for c in chars] + _corpus_words()
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces += [a + b for a in letters for b in letters]
    pieces += ["##" + a + b for a in letters for b in letters]
    pieces += [a + b + c for a in letters for b in letters for c in letters]
    pieces += ["##" + a + b + c for a in letters for b in letters
               for c in letters]
    for t in pieces:
        if len(vocab) == BERT_VOCAB:
            break
        vocab.setdefault(t, len(vocab))
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for t, i in BERT_SPECIALS.items()]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": None,
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab}}


def small_bpe_spec(regular: int = 1024) -> dict:
    """A byte-level BPE ``tokenizer.json`` (as a dict) with ``regular``
    tokens (the 256 bytes, the stdlib trainer's merges over
    ``TOKENIZER_CORPUS`` with GPT-2's split pattern, then
    ``_fill_merges``'s) and ``<|endoftext|>`` at id ``regular``: the
    recurrent models' tokenizer here (a served model's covers its whole
    vocabulary, so every sampled id decodes to text)."""
    from localai_tpu_torch.utils.hf_tokenizer import (
        BYTE_CHAR,
        GPT2_PATTERN,
        onig_regex,
    )

    words: dict = {}
    for w in onig_regex(GPT2_PATTERN).findall(TOKENIZER_CORPUS):
        w = "".join(BYTE_CHAR[b] for b in w.encode("utf-8"))
        words[w] = words.get(w, 0) + 1
    vocab = {BYTE_CHAR[b]: b for b in range(256)}
    merges: list = []
    _train_bpe(words, vocab, merges, regular)
    _fill_merges(vocab, merges, regular)
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": len(vocab), "content": "<|endoftext|>",
                          "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False,
                          "special": True}],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "vocab": vocab, "merges": merges}}


def _write_json(path, obj) -> None:
    Path(path).write_text(json.dumps(obj, ensure_ascii=False),
                          encoding="utf-8")


def _events_ms(fn) -> tuple:
    """(ms on CUDA events around one call of ``fn``, its result)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def _all_kernels() -> dict:
    """Every kernel wrapper of the port, by name (K1–K5 and the expert
    grid), for phases that must launch none of them."""
    from localai_tpu_torch.ops.attention import (
        decode_attention,
        paged_decode_attention,
        prefill_attention,
    )
    from localai_tpu_torch.ops.qmatmul import (
        w4_matmul,
        w8_matmul,
        w8_matmul_experts,
    )

    return {"paged_decode_attention": paged_decode_attention,
            "decode_attention": decode_attention,
            "prefill_attention": prefill_attention, "w8_matmul": w8_matmul,
            "w4_matmul": w4_matmul, "w8_matmul_experts": w8_matmul_experts}


def _no_launches(what: str, kernels: dict,
                 before: Optional[dict] = None) -> None:
    """Fail if a wrapper of ``kernels`` launched since its count was 0, or
    since the counts ``before`` (a snapshot taken by a phase that runs
    inside a group whose counts must stay whole)."""
    before = before or {}
    launched = {k: w.launches - before.get(k, 0)
                for k, w in kernels.items()
                if w.launches != before.get(k, 0)}
    if launched:
        raise AssertionError(f"{what} launched kernels of another path: "
                             f"{launched}")


def _recurrent(kind: str):
    """(module, config class, LM class) of ``mamba`` or ``rwkv``."""
    if kind == "mamba":
        from localai_tpu_torch.models import mamba as m

        return m, m.MambaConfig, m.MambaLM
    from localai_tpu_torch.models import rwkv as m

    return m, m.RwkvConfig, m.RwkvLM


def _prefill_fn(kind: str, mod, params, cfg):
    """ids → the serving prefill's [B, V] logits (head at the last row)."""
    if kind == "mamba":
        return lambda ids: mod.forward_prefill(params, cfg, ids,
                                               full=False)[0]
    return lambda ids: mod.forward(params, cfg, ids, None, full=False)[0]


def _step_fn(kind: str, mod, params, cfg):
    """(token [B], states) → (logits [B, V], states)."""
    if kind == "mamba":
        return lambda tok, st: mod.forward_step(params, cfg, tok, st)

    def step(tok, st):
        logits, st = mod.forward(params, cfg, tok[:, None], st)
        return logits[:, -1], st
    return step


def _full_logits(kind: str, mod, params, cfg, ids):
    """(logits at every position [B, L, V], states) of a fresh prefill."""
    if kind == "mamba":
        return mod.forward_prefill(params, cfg, ids)
    return mod.forward(params, cfg, ids)


PARITY_RECURRENT = {
    "mamba": {"model_type": "mamba", "vocab_size": 1025, "hidden_size": 128,
              "intermediate_size": 256, "num_hidden_layers": 4,
              "state_size": 16, "conv_kernel": 4, "time_step_rank": 8,
              "use_bias": False, "use_conv_bias": True,
              "layer_norm_epsilon": 1e-5, "eos_token_id": 1024},
    "rwkv": {"model_type": "rwkv", "vocab_size": 1025, "hidden_size": 128,
             "attention_hidden_size": 128, "intermediate_size": 512,
             "num_hidden_layers": 4, "layer_norm_epsilon": 1e-5,
             "eos_token_id": 1024},
}


def _noised(params: dict, seed: int) -> dict:
    """The drawn parameters with every vector (norms, biases, decays,
    D) and mix weight moved off its constant, so the recurrences are not
    degenerate."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in params.items():
        if v.dim() == 1 or "time_mix" in k:
            v = v + 0.3 * torch.randn(v.shape, generator=g).to(v.dtype)
        out[k] = v
    return out


def phase_recurrent_parity() -> dict:
    """Mamba and RWKV at small depth in float32, card against CPU: a
    checkpoint directory written here (HF layout, the small BPE
    tokenizer.json) loads through ``resolve_mamba`` / ``resolve_rwkv`` on
    both; prefill logits within 1e-4 of the largest, the decode step's
    logits against the prefill's at the next position (on each device and
    across), and 32 greedy tokens equal. Neither path launches K1–K5."""
    from localai_tpu_torch.models.loader import write_checkpoint

    kernels = _all_kernels()
    for w in kernels.values():
        w.launches = 0
    root = Path(_scratch_dir("recurrent-parity-", 200_000_000))
    out: dict = {}
    try:
        _write_json(root / "tokenizer.json", small_bpe_spec())
        for kind, hf in PARITY_RECURRENT.items():
            mod, cfg_cls, _ = _recurrent(kind)
            cfg = cfg_cls.from_hf(hf)
            params = _noised(mod.init_params(
                cfg, torch.Generator().manual_seed(7), "cpu"), 8)
            if kind == "mamba":   # an own head: a tied one echoes the input
                params["lm_head.weight"] = 0.05 * torch.randn(
                    cfg.vocab_size, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(9))
            ckpt = root / kind
            write_checkpoint(ckpt, hf, params)
            shutil.copy(root / "tokenizer.json", ckpt / "tokenizer.json")
            resolve = getattr(mod, f"resolve_{kind}")
            lms = {dev: resolve(str(ckpt), dtype="float32", device=dev)
                   for dev in ("cuda", "cpu")}
            prompt = lms["cpu"].tokenizer.encode(
                TOKENIZER_CORPUS[:400], add_bos=False)
            rec: dict = {"prompt_ids": len(prompt)}
            logits = {}
            with torch.no_grad():
                for dev, lm in lms.items():
                    ids = torch.tensor([prompt], device=dev)
                    full, _ = _full_logits(kind, mod, lm.params, lm.cfg, ids)
                    _, st = _full_logits(kind, mod, lm.params, lm.cfg,
                                         ids[:, :-1])
                    stepped, _ = _step_fn(kind, mod, lm.params, lm.cfg)(
                        ids[:, -1], st)
                    logits[dev] = (full.float().cpu(), stepped.float().cpu())
            ref = logits["cpu"][0]
            scale = float(ref.abs().max())
            err = float((logits["cuda"][0] - ref).abs().max())
            rec["prefill_max_abs_err"] = err
            rec["prefill_largest_logit"] = scale
            for dev in ("cuda", "cpu"):
                step_err = float((logits[dev][1][0] - ref[0, -1]).abs().max())
                rec[f"step_vs_prefill_{dev}"] = step_err
                if not step_err <= 1e-4 * scale:
                    raise AssertionError(
                        f"{kind}: the {dev} step's logits are {step_err} "
                        f"from the prefill's (largest {scale})")
            if not (torch.isfinite(ref).all() and err <= 1e-4 * scale):
                raise AssertionError(f"{kind}: card prefill logits {err} "
                                     f"from the CPU's (largest {scale})")
            toks = {dev: lm.generate(prompt, max_new_tokens=32, eos_ids=set())
                    for dev, lm in lms.items()}
            if toks["cuda"] != toks["cpu"] or len(toks["cpu"]) != 32:
                raise AssertionError(f"{kind}: greedy tokens differ: "
                                     f"{toks}")
            rec["greedy_tokens"] = toks["cuda"]
            print(f"recurrent_parity {kind}: {json.dumps(rec)}", flush=True)
            out[kind] = rec
            del lms
        _no_launches("recurrent parity", kernels)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _recurrent_profile(kind: str, mod, params, cfg, steps: int = 8) -> dict:
    """A decode step at the served widths: a 128-token prefill, then
    ``steps`` steps timed plain (wall) and under torch.profiler (device
    busy time and kernel launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = _step_fn(kind, mod, params, cfg)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 1024, (1, 128), generator=g).to("cuda")
    with torch.no_grad():
        if kind == "mamba":
            _, states = mod.forward_prefill(params, cfg, ids, full=False)
        else:
            _, states = mod.forward(params, cfg, ids, None, full=False)
        tok = torch.tensor([5], device="cuda")

        def run(n, st):
            for _ in range(n):
                logits, st = step(tok, st)
            return logits, st

        _, states = run(2, states)       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, states = run(steps, states)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, states = run(steps, states)
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) / steps
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{kind}: non-finite decode logits")
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in ev) / 1e3 / steps
    return {"decode_ms_per_token": wall * 1e3,
            "decode_ms_per_token_profiled": wall_prof * 1e3,
            "device_busy_ms_per_token": busy,
            "device_idle_share_vs_plain_wall": max(0.0, 1 - busy / (
                wall * 1e3)),
            "device_idle_share_vs_profiled_wall": max(0.0, 1 - busy / (
                wall_prof * 1e3)),
            "launches_per_token": sum(e.count for e in ev) / steps}


def _drawn_recurrent_model(mcfg, app, lm):
    """The facade ``backend: mamba | rwkv`` builds (``MambaServingModel``),
    over a model the phase drew on the card instead of one resolved from
    the config's ``model``: the same scheduler, templates and surface."""
    from localai_tpu_torch.models.mamba_serving import (
        MambaScheduler,
        MambaServingModel,
    )
    from localai_tpu_torch.templates.cache import TemplateCache

    class Drawn(MambaServingModel):
        def __init__(self):
            self.name, self.config = mcfg.name, mcfg
            self.lm, self.tokenizer = lm, lm.tokenizer
            self.templates = TemplateCache(app.model_path)
            self.vision, self.image_token_id = None, 0
            self.scheduler = MambaScheduler(lm, lm.tokenizer)
            self.loaded_at = self.last_used = time.monotonic()

    return Drawn()


def phase_serve_recurrent(card: str, kind: str) -> dict:
    """The recurrent serves: ``mamba-2.8b-bf16`` (state-spaces/mamba-2.8b-
    hf's widths) or ``rwkv-4-7b-bf16`` (RWKV/rwkv-4-7b-pile's), at the
    depths of ``SMOKE_LAYERS``, bf16 weights drawn on the card (the
    float32 tensors of the JAX package's loaders in float32), served as
    ``backend: mamba | rwkv`` through the port's HTTP server: five
    greedy 32-token chats (one streamed; generations run one at a time,
    as in the JAX package). It
    prints the weight bytes, peak memory, tokens/s, the streamed TTFT,
    prefill ms on CUDA events at 128, 512 and 2048 tokens, and a decode
    step's ms, launches and device idle share; K1–K5 launch never."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.utils.tokenizer import load_tokenizer

    name, hf = ((MAMBA, MAMBA_28B_CONFIG) if kind == "mamba"
                else (RWKV, RWKV_4_7B_CONFIG))
    hf = {**hf, "num_hidden_layers": SMOKE_LAYERS[kind]}
    mod, cfg_cls, lm_cls = _recurrent(kind)
    cfg = cfg_cls.from_hf(hf)
    kernels = _all_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    root = Path(_scratch_dir(f"{kind}-serve-", 10_000_000))
    _write_json(root / "tokenizer.json", small_bpe_spec(cfg.vocab_size - 1))
    t0 = time.monotonic()
    params = mod.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda", dtype="bfloat16")
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in params.values())
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    print(f"serve {name}: bf16 weights drawn on the card in {draw_s:.1f}s: "
          f"{n_params / 1e9:.3f} B parameters, {weight_bytes / 1e9:.3f} GB",
          flush=True)
    mcfg = ModelConfig.from_dict({"name": name, "backend": kind,
                                  "model": name,
                                  "engine": {"dtype": "bfloat16"}})
    mcfg.set_defaults()
    loader = ConfigLoader()
    loader.register(mcfg)
    app = AppConfig(device="cuda")
    lm = lm_cls(cfg, params, load_tokenizer(root))
    sm = _drawn_recurrent_model(mcfg, app, lm)
    manager = _one_model_manager(app, loader, sm)
    server = APIServer(manager, "127.0.0.1", 0).start()
    try:
        chat = server.url + "/v1/chat/completions"
        json.loads(_post(chat, {"model": name, "max_tokens": 4,
                                "messages": [{"role": "user",
                                              "content": "hi"}]}).read())
        for w in kernels.values():
            w.launches = 0
        res = _chats(chat, name, extra={"ignore_eos": True})
        if res["tokens"] != 5 * 32:
            raise AssertionError(f"{name}: {res['tokens']} tokens, not "
                                 "5 x 32")
        peaks = {"chats": torch.cuda.max_memory_allocated() / 1e9}
        prefill = {}
        with torch.no_grad():
            fn = _prefill_fn(kind, mod, params, cfg)
            g = torch.Generator().manual_seed(2)
            for T in (128, 512, 2048):
                ids = torch.randint(0, 1024, (1, T), generator=g).to("cuda")
                torch.cuda.reset_peak_memory_stats()
                ms, logits = _events_ms(lambda: fn(ids))
                if not torch.isfinite(logits).all():
                    raise AssertionError(f"{name}: non-finite logits at "
                                         f"T={T}")
                prefill[T] = ms
                peaks[f"prefill_{T}"] = (torch.cuda.max_memory_allocated()
                                         / 1e9)
        torch.cuda.reset_peak_memory_stats()
        prof = _recurrent_profile(kind, mod, params, cfg)
        peaks["decode"] = torch.cuda.max_memory_allocated() / 1e9
        _no_launches(name, kernels)
        peak = max(peaks.values())
        rec = {"card": card, "model": name, "backend": kind,
               "weights": "bfloat16", "parameters_b": n_params / 1e9,
               "weight_gb": weight_bytes / 1e9, "draw_s": draw_s,
               "requests": 5, "streaming": 1,
               "completion_tokens": res["tokens"], "wall_s": res["wall_s"],
               "tokens_per_s": res["tokens"] / res["wall_s"],
               "ttft_stream_s": res["ttft_s"],
               "prefill_ms": prefill, **prof,
               "max_memory_allocated_gb": peak, "peak_gb_by_part": peaks,
               "k1_k5_launches": 0}
        print("serve: " + json.dumps(rec), flush=True)
        if not peak < 80:
            raise AssertionError(f"{name}: peak memory {peak} GB")
        return rec
    finally:
        server.shutdown()
        manager.shutdown()
        sm = lm = params = manager = server = None
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _documents(rng, n: int, lo: int, hi: int) -> list:
    """``n`` texts of ``lo``..``hi`` corpus words each (every word one
    WordPiece token of ``bert_tokenizer_spec``'s vocabulary)."""
    words = [w for w in _corpus_words() if w.isascii() and w.isalpha()]
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def phase_encoders(card: str) -> dict:
    """The encoders through the port's server, with the 30522-id
    WordPiece tokenizer.json written here: ``/v1/rerank`` on a
    cross-encoder at cross-encoder/ms-marco-MiniLM-L-6-v2's widths (one
    query against 32 documents of 30–300 words, then four more requests)
    and ``/v1/embeddings`` on a sentence encoder at BAAI/bge-large-en-
    v1.5's (at the depth of ``SMOKE_LAYERS``; 64 inputs of 10–400
    tokens; a token array is refused), both
    float32 checkpoints of seeded weights drawn on the CPU and loaded from
    a models dir by the manager. Scores and vectors are held to the CPU's
    on the same checkpoints within 1e-4 (all 32 scores, all 64 vectors).
    Prints ms a request and inputs/s (wall), the encoder forward on CUDA
    events, peak memory; K1–K5 launch never."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.loader import write_checkpoint
    from localai_tpu_torch.models.manager import ModelManager
    from localai_tpu_torch.models.reranker import (
        BertConfig,
        embed_forward,
        forward,
        hf_tensors,
        init_params,
        resolve_reranker,
        resolve_sentence_encoder,
    )

    kernels = _all_kernels()
    root = Path(_scratch_dir("encoders-", 3_000_000_000))
    models = root / "models"
    models.mkdir()
    spec = bert_tokenizer_spec()
    server = manager = None
    try:
        for sub, hf, head, seed in (("minilm-ce", MINILM_L6_CE_CONFIG, True,
                                     11),
                                    ("bge-large", {
                                        **BGE_LARGE_CONFIG,
                                        "num_hidden_layers":
                                            SMOKE_LAYERS["bge-large"]},
                                     False, 12)):
            cfg = BertConfig.from_hf(hf)
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 "cpu")
            write_checkpoint(root / sub, hf, hf_tensors(
                params, root="bert." if head else "", head=head))
            _write_json(root / sub / "tokenizer.json", spec)
            del params
        (models / "r.yaml").write_text(
            f"name: {RERANKER}\nbackend: reranker\nmodel: "
            f"{root / 'minilm-ce'}\n")
        (models / "e.yaml").write_text(
            f"name: {EMBEDDER}\nbackend: bert-embeddings\nmodel: "
            f"{root / 'bge-large'}\n")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loader = ConfigLoader(models)
        loader.load_from_path()
        manager = ModelManager(AppConfig(model_path=str(models),
                                         device="cuda"), loader)
        server = APIServer(manager, "127.0.0.1", 0).start()
        for w in kernels.values():
            w.launches = 0
        rng = np.random.default_rng(0)
        query = "how does a cache keep the hot set close to the processor"
        docs = _documents(rng, 32, 30, 300)
        more = [(_documents(rng, 1, 5, 12)[0], _documents(rng, 8, 30, 120))
                for _ in range(4)]
        rr = server.url + "/v1/rerank"
        t0 = time.monotonic()
        first = json.loads(_post(rr, {"model": RERANKER, "query": query,
                                      "documents": docs}).read())
        load_s = time.monotonic() - t0
        walls = []
        for q, ds in [(query, docs)] + more:
            t0 = time.monotonic()
            out = json.loads(_post(rr, {"model": RERANKER, "query": q,
                                        "documents": ds}).read())
            walls.append(time.monotonic() - t0)
            if len(out["results"]) != len(ds):
                raise AssertionError(f"{RERANKER}: {len(out['results'])} "
                                     f"results for {len(ds)} documents")
        card_scores = np.zeros(len(docs))
        for r in first["results"]:
            card_scores[r["index"]] = r["relevance_score"]
        ce = manager.get_reranker(RERANKER).encoder
        cpu_ce = resolve_reranker(str(root / "minilm-ce"), device="cpu")
        cpu_scores, ntok = cpu_ce.score_with_usage(query, docs)
        ce_err = float(np.abs(card_scores - cpu_scores).max())
        if not (np.isfinite(card_scores).all() and ce_err <= 1e-4
                and first["usage"]["total_tokens"] == ntok):
            raise AssertionError(f"{RERANKER}: card scores {ce_err} from "
                                 f"the CPU's; usage {first['usage']} vs "
                                 f"{ntok}")
        L = max(len(ce.tokenizer.encode(d)) for d in docs) + 3
        ids = torch.randint(1000, BERT_VOCAB, (32, 512)).to("cuda")
        seg = torch.zeros_like(ids)
        mask = torch.ones_like(ids, dtype=torch.bool)
        with torch.no_grad():
            ce_fwd_ms, _ = _events_ms(lambda: forward(
                ce.params, ce.cfg, ids, seg, mask))
        rerank = {"request_ms": [w * 1e3 for w in walls],
                  "first_request_s_with_load": load_s,
                  "pairs_per_s": sum(len(ds) for _, ds in [(query, docs)]
                                     + more) / sum(walls),
                  "forward_ms_32x512_events": ce_fwd_ms,
                  "longest_pair_tokens": L, "max_abs_err_vs_cpu": ce_err,
                  "total_tokens": ntok}
        # embeddings: 64 inputs of 10..400 tokens
        texts = _documents(rng, 62, 10, 400) + _documents(rng, 1, 400, 400) \
            + _documents(rng, 1, 10, 10)
        em_url = server.url + "/v1/embeddings"
        json.loads(_post(em_url, {"model": EMBEDDER,
                                  "input": "warm up"}).read())
        t0 = time.monotonic()
        emb = json.loads(_post(em_url, {"model": EMBEDDER,
                                        "input": texts}).read())
        em_wall = time.monotonic() - t0
        vecs = np.asarray([d["embedding"] for d in emb["data"]])
        try:
            _post(em_url, {"model": EMBEDDER, "input": [[101, 2000, 102]]})
            raise AssertionError(f"{EMBEDDER}: a token array was accepted")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
        cpu_em = resolve_sentence_encoder(str(root / "bge-large"),
                                          device="cpu")
        cpu_vecs, _ = cpu_em.embed_with_usage(texts)
        em_err = float(np.abs(vecs - cpu_vecs).max())
        norms = np.linalg.norm(vecs, axis=1)
        if not (vecs.shape == (64, BGE_LARGE_CONFIG["hidden_size"])
                and np.isfinite(vecs).all()
                and np.allclose(norms, 1.0, atol=1e-4) and em_err <= 1e-4):
            raise AssertionError(f"{EMBEDDER}: vectors {vecs.shape}, "
                                 f"{em_err} from the CPU's")
        em = manager.get_embedder(EMBEDDER).encoder
        ids = torch.randint(1000, BERT_VOCAB, (64, 512)).to("cuda")
        seg = torch.zeros_like(ids)
        mask = torch.ones_like(ids, dtype=torch.bool)
        with torch.no_grad():
            em_fwd_ms, _ = _events_ms(lambda: embed_forward(
                em.params, em.cfg, ids, seg, mask))
        tok_lens = [len(em.tokenizer.encode(t)) for t in texts]
        embed = {"request_ms": em_wall * 1e3, "inputs_per_s": 64 / em_wall,
                 "input_tokens": [min(tok_lens), max(tok_lens)],
                 "usage_tokens": emb["usage"]["prompt_tokens"],
                 "forward_ms_64x512_events": em_fwd_ms,
                 "max_abs_err_vs_cpu": em_err}
        _no_launches("the encoders", kernels)
        rec = {"card": card, "rerank": rerank, "embeddings": embed,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "k1_k5_launches": 0}
        print("encoders: " + json.dumps(rec), flush=True)
        return rec
    finally:
        if server is not None:
            server.shutdown()
        if manager is not None:
            manager.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# -- self-extend, int8_w8a8 weights and the disk prompt cache ----------------

# rows of the w8a8 product's timed cases (a decode step, a verify window of
# 8 slots x (gamma 4 + 1), a prefill chunk's cap) and its untimed edges
# around torch._int_mm's 16-row floor (the padded rows)
W8A8_MS = (8, SPEC_M, 256)
W8A8_EDGES = (1, 16, 17)
SE_PROMPTS = [[(i * 7 + 3) % 256 for i in range(150)], list(b"hi there")]
PC_PROMPT = list(b"A shared system prompt that the disk cache keeps: "
                 b"be brief, be right.")
# the prompt-cache serve's shared system prompt (~2000 byte tokens)
PC_PREFIX = " ".join(
    f"Rule {i}: answer in plain words, cite the manual section {i}."
    for i in range(1, 400))[:2000]


def w8a8_case(M, K, N, *, seed, timed=True, transpose=False) -> dict:
    """The int8_w8a8 product at x [M, K] against a weight [K, N] (or, with
    ``transpose``, an [N, K] table) quantized by the port's own quantizer
    from a seeded normal draw: ``int8_matmul`` (torch._int_mm, rows padded
    past its 16-row floor, K and N to multiples of 8) must equal the
    exact float64 product. Timed:
    the whole w8a8 matmul (per-token quantize of bf16 x, product, both
    scales), the product alone, the float64 plain version, K4 on the same
    weight as w8 (where K4 takes the shape), and a bf16 torch.matmul,
    beside the bound at the int8 peak."""
    from localai_tpu_torch.models import quant as tq
    from localai_tpu_torch.ops import qmatmul as qmm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((N, K) if transpose else (K, N), generator=g,
                    device="cuda") * 0.02
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    axis = 1 if transpose else 0
    qt = tq.quantize_tensor(w, axis, "w8a8")
    xq, _ = tq.quantize_lastdim(x)
    got = tq.int8_matmul(xq, qt.q, transpose)
    want = tq.int8_matmul_ref(xq, qt.q, transpose)
    torch.cuda.synchronize()
    rec = {"case": f"w8a8{'-T' if transpose else ''}", "M": M, "K": K,
           "N": N, "exact": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max())}
    del got, want
    if timed:
        mm = tq.matmul_t if transpose else tq.matmul
        w8 = tq.quantize_tensor(w, axis)
        w_bf16 = w.to(torch.bfloat16)
        if transpose:
            w_bf16 = w_bf16.T
        nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
        rec.update(
            ms=time_ms(lambda: mm(x, qt)),
            product_ms=time_ms(lambda: tq.int8_matmul(xq, qt.q, transpose)),
            plain_ms=time_ms(lambda: tq.int8_matmul_ref(xq, qt.q, transpose),
                             iters=5, warmup=1),
            # K4 takes 128-aligned widths only (not a 32001-id vocabulary)
            k4_ms=(time_ms(lambda: mm(x, w8)) if qmm.eligible(
                tuple(x.shape), w8.q, w8.scale, transpose) else None),
            bf16_ms=time_ms(lambda: torch.matmul(x, w_bf16)),
            **_bound(nbytes, 2 * M * K * N, torch.int8))
        del w8, w_bf16
    print("w8a8 case", json.dumps(rec), flush=True)
    if not rec["exact"]:
        raise AssertionError(f"w8a8 product M={M} K={K} N={N}"
                             f"{' (transposed)' if transpose else ''} "
                             f"differs from the exact product")
    return rec


def phase_w8a8() -> dict:
    """The int8_w8a8 product at Llama-3-8B's projections and lm_head at
    M = 8, 40 and 256 (timed) and 1, 16 and 17 (exactness only), a tied
    lm_head table, and a 32001-id lm_head (timed) and tied table;
    prints each step's sum against K4 and bf16.
    Returns the timed records by "<shape>-m<M>"."""
    out: dict = {}
    seed = 700
    for label, ((K, N), _) in SHAPES_8B.items():
        for M in W8A8_MS + W8A8_EDGES:
            seed += 1
            rec = w8a8_case(M, K, N, seed=seed, timed=M in W8A8_MS)
            if M in W8A8_MS:
                out[f"{label}-m{M}"] = rec
    w8a8_case(8, 2048, 128256, seed=seed + 1, transpose=True, timed=False)
    # a vocabulary of 32001 ids (a Llama-2 fine-tune's added pad token):
    # N off a multiple of 8, in the lm_head and a tied table
    for M in W8A8_MS + W8A8_EDGES:
        seed += 2
        out[f"lm_head-v32001-m{M}"] = w8a8_case(
            M, 4096, 32001, seed=seed, timed=M in W8A8_MS)
        w8a8_case(M, 4096, 32001, seed=seed + 1, transpose=True, timed=False)
    count = {s: (c * L_8B if c else 1) for s, (_, c) in SHAPES_8B.items()}
    for M in W8A8_MS:
        step = {f: sum(out[f"{s}-m{M}"][f] * n for s, n in count.items())
                for f in ("ms", "product_ms", "k4_ms", "bf16_ms",
                          "bound_ms")}
        print(f"w8a8 matmuls of one 8B forward at M={M} (7 projections x "
              f"{L_8B} layers + lm_head, from the cases above): "
              + json.dumps(step), flush=True)
    return out


def _greedy_rows(r, prompts, steps: int = 16) -> list:
    out, slots = [], []
    for p in prompts:
        s = r.acquire_slot()
        out.append([r.admit(s, list(p), temperature=0.0)])
        slots.append(s)
    for _ in range(steps):
        toks = r.step()
        for o, s in zip(out, slots):
            o.append(int(toks[s]))
    return out


def phase_w8a8_selfextend_parity() -> dict:
    """Card = CPU greedy tokens (debug:small, float32): int8_w8a8 weights
    with an int8 pool on the paged layout (K1 launches, K4 none), and
    self-extend (ga_n 4, ga_w 32) on the contiguous layout past a trained
    context shortened to 64, float32 and int8 caches (no kernel launch).
    Returns the card runs' launches by mode."""
    import dataclasses

    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.models.quant import quantize_params
    from localai_tpu_torch.models.registry import resolve_model

    kernels = _all_kernels()
    model = resolve_model("debug:small", dtype="float32", device="cpu")
    short = dataclasses.replace(model.cfg, max_position_embeddings=64)
    runs = [("paged-w8a8-int8", model.cfg,
             quantize_params(model.params, "int8_w8a8", device="cpu"),
             dict(kv_dtype="int8", kv_block_tokens=16, prefill_chunk=32,
                  paged=True)),
            ("selfextend-float32", short, model.params,
             dict(kv_dtype="float32", paged=False, ga_n=4, ga_w=32)),
            ("selfextend-int8", short, model.params,
             dict(kv_dtype="int8", paged=False, ga_n=4, ga_w=32))]
    launches = {}
    for mode, cfg, params, kw in runs:
        prompts = SE_PROMPTS if "selfextend" in mode else [
            list(b"The paged kernel walks each block table"), list(b"hi")]
        seqs = {}
        for dev in ("cuda", "cpu"):
            r = ModelRunner(cfg, _to(params, dev), num_slots=4, max_ctx=256,
                            prefill_buckets=[64, 128, 256], device=dev, **kw)
            for w in kernels.values():
                w.launches = 0
            seqs[dev] = _greedy_rows(r, prompts)
            counts = {n: w.launches for n, w in kernels.items()}
            print(f"parity {mode} {dev} (attention {r.attn_impl}): "
                  f"{seqs[dev]} launches {json.dumps(counts)}", flush=True)
            if dev == "cuda":
                launches[mode] = counts
                if "selfextend" in mode:
                    _no_launches(f"parity {mode}", kernels)
                elif counts["paged_decode_attention"] <= 0 or counts[
                        "w8_matmul"]:
                    raise AssertionError(f"parity {mode}: launches {counts}"
                                         " (want K1 > 0, K4 0)")
            del r
        if seqs["cuda"] != seqs["cpu"]:
            raise AssertionError(
                f"greedy tokens differ between cuda and cpu ({mode})")
    return launches


def phase_prompt_cache_parity() -> dict:
    """The disk prompt cache, card = CPU (debug:small, float32): on the
    paged and contiguous layouts with float32 and int8 KV, a cold serve
    stores the prompt, a new runner and scheduler on the directory serve
    it again from a hit with the cold tokens, on both devices alike; and
    the directory the card wrote is served by the CPU with those tokens.
    Returns the card runs' launches by mode."""
    import tempfile

    from localai_tpu_torch.engine.promptcache import PromptKVCache
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler
    from localai_tpu_torch.models.registry import resolve_model

    kernels = _all_kernels()
    model = resolve_model("debug:small", dtype="float32", device="cpu")
    root = tempfile.mkdtemp(prefix="prompt-cache-parity-")
    launches = {}

    def serve(dev, params, kw, path):
        r = ModelRunner(model.cfg, params, num_slots=2, max_ctx=256,
                        prefill_buckets=[64, 128], device=dev, **kw)
        cache = PromptKVCache(path)
        s = Scheduler(r, model.tokenizer, multi_step=4, prompt_cache=cache)
        try:
            toks = s.generate(GenRequest(prompt=list(PC_PROMPT),
                                         max_new_tokens=12, temperature=0.0,
                                         ignore_eos=True),
                              timeout=300).token_ids
        finally:
            s.shutdown()
        return toks, cache, r.total_prefix_reused

    try:
        for paged in (True, False):
            for kv in ("float32", "int8"):
                mode = f"{'paged' if paged else 'contiguous'}-{kv}"
                kw = dict(kv_dtype=kv, paged=paged)
                if paged:
                    kw.update(kv_block_tokens=16, prefill_chunk=32)
                toks, paths = {}, {}
                for dev in ("cuda", "cpu"):
                    params = _to(model.params, dev)
                    path = paths[dev] = f"{root}/{mode}-{dev}"
                    for w in kernels.values():
                        w.launches = 0
                    cold, c1, _ = serve(dev, params, kw, path)
                    warm, c2, reused = serve(dev, params, kw, path)
                    if not (c1.stores == 1 and c2.hits == 1 and reused > 0):
                        raise AssertionError(
                            f"prompt cache {mode} {dev}: stores {c1.stores}"
                            f", hits {c2.hits}, reused {reused}")
                    if dev == "cuda":
                        launches[mode] = {n: w.launches
                                          for n, w in kernels.items()}
                        k = ("paged_decode_attention" if paged
                             else "decode_attention")
                        if launches[mode][k] <= 0:
                            raise AssertionError(f"prompt cache {mode}: no "
                                                 f"{k} launch")
                    toks[dev] = (cold, warm)
                    del params
                read, c3, _ = serve("cpu", model.params, kw, paths["cuda"])
                on_card, on_cpu = toks["cuda"], toks["cpu"]
                print(f"prompt cache parity {mode}: cold/warm cuda "
                      f"{on_card}, cpu {on_cpu}, the card's directory on "
                      f"the cpu {read} (hits {c3.hits}); card launches "
                      f"{json.dumps(launches[mode])}", flush=True)
                if not (on_card[0] == on_card[1] == on_cpu[0] == on_cpu[1]
                        == read and c3.hits == 1):
                    raise AssertionError(f"prompt cache parity {mode}: "
                                         "tokens differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


class _Served:
    """One engine from a model YAML document, built by the port's manager
    (``build_serving_model``, as a user's YAML is) and served over HTTP;
    the model is freed on exit so the next phase's peak memory is its
    own."""

    def __init__(self, doc: dict, models_path: Optional[str] = None,
                 app: Optional[dict] = None):
        from localai_tpu_torch.api.server import APIServer
        from localai_tpu_torch.config.app_config import AppConfig
        from localai_tpu_torch.config.loader import ConfigLoader
        from localai_tpu_torch.config.model_config import ModelConfig
        from localai_tpu_torch.models.manager import ModelManager

        mcfg = ModelConfig.from_dict(doc)
        mcfg.set_defaults()
        loader = ConfigLoader()
        loader.register(mcfg)
        app = AppConfig(device="cuda", **(app or {}))
        if models_path is not None:
            app.model_path = models_path
        self.name = mcfg.name
        self.manager = ModelManager(app, loader)
        self.server = APIServer(self.manager, "127.0.0.1", 0).start()
        self.chat = self.server.url + "/v1/chat/completions"
        t0 = time.monotonic()
        try:
            self.sm = self.manager.get(self.name)
        except BaseException:
            self.__exit__()
            raise
        torch.cuda.synchronize()
        self.load_s = time.monotonic() - t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.manager.shutdown()
        self.sm = self.manager = self.server = None
        gc.collect()
        torch.cuda.empty_cache()


def _streamed_chat(url: str, body: dict, key: Optional[str] = None) -> dict:
    """One streamed chat (with a bearer ``key``): {"text", "ttft_s",
    "status", "tokens", "finish"}; an error in the stream is its finish
    reason."""
    t = time.monotonic()
    ttft, text, last = None, "", None
    with _post(url, {**body, "stream": True}, key=key) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: {"):
                continue
            frame = json.loads(line[6:])
            if frame.get("choices"):
                delta = frame["choices"][0]["delta"].get("content")
                if delta and ttft is None:
                    ttft = time.monotonic() - t
                text += delta or ""
            last = frame
    return {"text": text, "ttft_s": ttft, "status": r.status,
            "tokens": (last or {}).get("usage", {}).get(
                "completion_tokens", 0),
            "finish": (last or {}).get("choices", [{}])[0].get(
                "finish_reason")}


def _five_chats(srv, card: str, kernels: dict, extra: dict) -> tuple:
    """The serves' warm-up chat, then the five chats (one streamed) with
    every count at 0 just before and read just after; prints and returns
    the serve's record (``extra`` joins it)."""
    _chats(srv.chat, srv.name, n=1)
    torch.cuda.reset_peak_memory_stats()
    run = _counted(srv.sm, kernels, lambda: _chats(srv.chat, srv.name))
    chats = run.pop("result")
    rec = {"card": card, "model": srv.name, "requests": 5, "streaming": 1,
           "kv_layout": "paged" if srv.sm.runner.paged else "contiguous",
           "kv_dtype": srv.sm.runner.kv_dtype,
           "speculation": srv.sm.scheduler.spec is not None,
           "completion_tokens": chats["tokens"], "wall_s": chats["wall_s"],
           "tokens_per_s": chats["tokens"] / chats["wall_s"],
           "ttft_stream_s": chats["ttft_s"], "launches": run,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9, **extra}
    return rec, chats


def _check_k1(name: str, run: dict, L: int) -> None:
    """K1 once per layer per plain decode step, and nothing else."""
    want = L * run["decode_steps"]
    if run["decode_steps"] <= 0 or run["paged_decode_attention"] != want:
        raise AssertionError(f"{name}: K1 launches "
                             f"{run['paged_decode_attention']}, expected "
                             f"{want} ({L} x {run['decode_steps']} steps)")
    other = {k: run[k] for k in ("decode_attention", "prefill_attention",
                                 "w8_matmul", "w4_matmul",
                                 "w8_matmul_experts") if run[k]}
    if other:
        raise AssertionError(f"{name}: launches of another path {other}")


def phase_serve_w8a8(card: str) -> dict:
    """``llama3-8b-w8a8``: debug:llama3-8b (Llama-3-8B's widths and depth,
    seeded random weights drawn on the card) with ``quantization:
    int8_w8a8`` and an int8 pool, the default paged layout with
    speculation; five chats over HTTP, one streamed. Asserts K1 32 a plain
    decode step and K4 0 (no w8a8 projection reaches it). Returns the
    launch counts."""
    doc = {"name": "llama3-8b-w8a8", "model": "debug:llama3-8b",
           "context_size": 4096,
           "engine": {"dtype": "bfloat16", "kv_dtype": "int8",
                      "max_slots": 8, "kv_block_tokens": 64,
                      "quantization": "int8_w8a8"}}
    with _Served(doc) as srv:
        runner = srv.sm.runner
        if not (runner.paged and srv.sm.scheduler.spec is not None
                and runner.params["layers"]["wq"].mode == "w8a8"):
            raise AssertionError(f"{srv.name}: not a paged w8a8 engine "
                                 "with speculation")
        wb = _weight_bytes(runner.params)["total"]
        rec, _ = _five_chats(srv, card, _all_kernels(), {
            "weights": "int8_w8a8", "weight_gb": wb / 1e9,
            "load_s": srv.load_s})
        print("serve: " + json.dumps(rec), flush=True)
        _check_k1(srv.name, rec["launches"], runner.cfg.num_layers)
        return rec["launches"]


def phase_serve_selfextend(card: str) -> dict:
    """``llama3-8b-bf16-selfextend``: debug:llama3-8b in bf16 with
    ``grp_attn_n: 2``, ``grp_attn_w: 2048`` and ``context_size: 16384``
    (twice the trained 8192) and no layout key: the manager must take the
    contiguous layout with speculation off. Five chats (one streamed),
    then a prompt of about 12000 tokens, past the trained context,
    answered with one token (its wall is the TTFT) and then with 32.
    Asserts no kernel launch (K2 and K3 take roped K only). Returns the
    launch counts."""
    doc = {"name": "llama3-8b-bf16-selfextend", "model": "debug:llama3-8b",
           "context_size": 16384,
           "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                      "max_slots": 8, "grp_attn_n": 2, "grp_attn_w": 2048}}
    kernels = _all_kernels()
    with _Served(doc) as srv:
        runner = srv.sm.runner
        if runner.paged or srv.sm.scheduler.spec is not None or (
                runner.max_ctx != 16384 or runner.attn_impl != "plain"):
            raise AssertionError(
                f"{srv.name}: paged {runner.paged}, speculation "
                f"{srv.sm.scheduler.spec is not None}, context "
                f"{runner.max_ctx}, attention {runner.attn_impl}")
        rec, _ = _five_chats(srv, card, kernels, {
            "weights": "bfloat16", "grp_attn_n": 2, "grp_attn_w": 2048,
            "context": runner.max_ctx, "load_s": srv.load_s})
        text = " ".join(f"Item {i} of the inventory list: a crate of "
                        f"{i % 17} bolts." for i in range(1, 400))[:12000]

        def long_chat(max_tokens):
            t0 = time.monotonic()
            out = json.loads(_post(srv.chat, {
                "model": srv.name, "max_tokens": max_tokens,
                "temperature": 0,
                "messages": [{"role": "user", "content": text}]}).read())
            return time.monotonic() - t0, out

        torch.cuda.reset_peak_memory_stats()
        # TTFT as the wall of a one-token answer (random weights may
        # stream bytes that decode to no text for a while)
        long = _counted(srv.sm, kernels,
                        lambda: (long_chat(1), long_chat(32)))
        (ttft, _), (wall, got) = long.pop("result")
        if got["usage"]["completion_tokens"] <= 0:
            raise AssertionError(f"{srv.name}: the long prompt returned no "
                                 "tokens")
        rec["long_prompt"] = {
            "prompt_tokens": got["usage"]["prompt_tokens"], "ttft_s": ttft,
            "wall_s": wall,
            "completion_tokens": got["usage"]["completion_tokens"],
            "finish": got["choices"][0]["finish_reason"], "launches": long,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}
        print("serve: " + json.dumps(rec), flush=True)
        for run in (rec["launches"], long):
            if any(run[k] for k in kernels):
                raise AssertionError(f"{srv.name}: kernel launches {run}")
        return rec["launches"]


def phase_serve_prompt_cache(card: str, ref_texts: Optional[list] = None
                             ) -> dict:
    """``llama3-8b-bf16-promptcache``: debug:llama3-8b in bf16, the default
    paged layout with speculation, and ``prompt_cache_path``. The five
    chats (K1 32 a plain step), then a streamed chat behind a shared
    system prompt of about 2000 tokens (cold), which stores one entry;
    the server restarts on the directory and answers a streamed chat
    sharing the prefix (warm, a hit) and the cold chat again. Prints the
    TTFTs, the entry's bytes against 131072 B a token, the writer's store
    ms, the lookup and load ms, and how many of the five texts equal
    ``ref_texts`` (the cache-less bf16 server's). Raises unless the cold
    chat asked again on a hit gives the cold text. Returns the launch
    counts of the five chats and the restarted server's two chats."""
    root = _scratch_dir("prompt-cache-serve-", 2_000_000_000)
    doc = {"name": "llama3-8b-bf16-promptcache", "model": "debug:llama3-8b",
           "context_size": 4096, "prompt_cache_path": "pc",
           "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                      "max_slots": 8, "kv_block_tokens": 64}}
    kernels = _all_kernels()

    def shared(question):
        return {"model": doc["name"], "max_tokens": 32, "temperature": 0,
                "messages": [{"role": "system", "content": PC_PREFIX},
                             {"role": "user", "content": question}]}

    try:
        with _Served(doc, models_path=root) as srv:
            if not (srv.sm.runner.paged and srv.sm.scheduler.spec is not None
                    and srv.sm.scheduler.prompt_cache is not None):
                raise AssertionError(f"{srv.name}: not a paged engine with "
                                     "speculation and a prompt cache")
            rec, chats = _five_chats(srv, card, kernels, {
                "weights": "bfloat16", "load_s": srv.load_s})
            _check_k1(srv.name, rec["launches"], srv.sm.runner.cfg.num_layers)
            texts = [chats["results"][i]["choices"][0]["message"]["content"]
                     for i in range(4)] + [chats["results"][4]["text"]]
            if ref_texts is not None:
                rec["texts_equal_to_cacheless"] = sum(
                    a == b for a, b in zip(texts, ref_texts))
            sched, cache = srv.sm.scheduler, srv.sm.scheduler.prompt_cache
            # the five chats' entries stored first, so the writer's
            # seconds below are the shared-prefix entry's alone
            stores = -1
            while stores != cache.stores or not sched._pc_queue.empty():
                stores = cache.stores
                time.sleep(0.5)
            store0 = sched.pc_seconds["store_s"]
            cold = _streamed_chat(srv.chat, shared("Which rule is first?"))

            def longest():
                with cache._lock:
                    return max(cache._index.items(),
                               key=lambda kv: len(kv[1]))

            deadline = time.monotonic() + 120
            while (len(longest()[1]) < len(PC_PREFIX)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            key, toks = longest()
            m = sched.metrics()["prompt_cache"]
            cfg = srv.sm.runner.cfg
            entry = {"tokens": len(toks),
                     "bytes": (Path(cache.dir) / f"{key}.npz").stat().st_size,
                     # K and V, bf16, every layer and KV head
                     "reckoned_bytes": len(toks) * cfg.num_layers * 2
                     * cfg.num_kv_heads * cfg.hd * 2,
                     "store_ms": 1e3 * (m["store_s"] - store0),
                     "stores": m["stores"]}
            if len(toks) < len(PC_PREFIX):
                raise AssertionError(f"{srv.name}: the shared-prefix chat "
                                     "stored no entry")
        with _Served(doc, models_path=root) as srv:
            sched = srv.sm.scheduler
            seconds = []

            def chat(question):
                out = _streamed_chat(srv.chat, shared(question))
                seconds.append(dict(sched.pc_seconds))
                return out

            run = _counted(srv.sm, kernels, lambda: (
                chat("Which rule is last?"), chat("Which rule is first?")))
            warm, again = run.pop("result")
            m = sched.metrics()["prompt_cache"]
            if m["hits"] < 2 or srv.sm.runner.total_prefix_reused < 2000:
                raise AssertionError(f"{srv.name}: restarted without reuse:"
                                     f" {m}, reused "
                                     f"{srv.sm.runner.total_prefix_reused}")
            _check_k1(srv.name + " (restarted)", run,
                      srv.sm.runner.cfg.num_layers)
            rec.update(
                cold_ttft_s=cold["ttft_s"], warm_ttft_s=warm["ttft_s"],
                repeat_ttft_s=again["ttft_s"], entry=entry,
                # the warm chat's own lookup (index scan + npz read) and
                # load (host to card, the scatter into its blocks)
                lookup_ms=1e3 * seconds[0]["lookup_s"],
                load_ms=1e3 * seconds[0]["load_s"],
                restarted_hits=m["hits"],
                prefix_reused=srv.sm.runner.total_prefix_reused,
                repeat_text_equal=again["text"] == cold["text"],
                restarted_launches=run)
        print("serve: " + json.dumps(rec), flush=True)
        if not rec["repeat_text_equal"]:
            raise AssertionError(f"{srv.name}: the cold chat asked again on "
                                 "a cache hit gave another text: "
                                 f"{again['text']!r} vs {cold['text']!r}")
        return {k: n + run[k] for k, n in rec["launches"].items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# speech and sound: whisper transcription, VITS voices with cloning, the
# parametric voice and MusicGen-class sound generation (no K1–K5 on these
# paths: the JAX package computes them in XLA, the port in plain torch)
# ---------------------------------------------------------------------------

# openai/whisper-large-v3's published config.json (its widths and depth;
# the checkpoint is published in float16)
WHISPER_LARGE_V3_CONFIG = {
    "architectures": ["WhisperForConditionalGeneration"],
    "model_type": "whisper", "d_model": 1280,
    "encoder_attention_heads": 20, "decoder_attention_heads": 20,
    "encoder_layers": 32, "decoder_layers": 32, "encoder_ffn_dim": 5120,
    "decoder_ffn_dim": 5120, "num_mel_bins": 128, "vocab_size": 51866,
    "max_source_positions": 1500, "max_target_positions": 448,
    "bos_token_id": 50257, "eos_token_id": 50257, "pad_token_id": 50256,
    "decoder_start_token_id": 50258, "torch_dtype": "float16"}
WHISPER = "whisper-large-v3-f32"
# facebook/mms-tts-eng's published config.json is the VitsConfig defaults
# (hidden 192, 6 layers, HiFi-GAN 512 x (8, 8, 2, 2), 16 kHz); its
# vocab.json holds 38 symbols
MMS_VOCAB = "_ abcdefghijklmnopqrstuvwxyz0123456789"
VITS = "vits-mms-tts-eng"
VITS_CLONE = "vits-mms-tts-eng-speakers"
# a voice drawn at this std gives ~1-3 frames (256 samples each) a symbol
VITS_STD = 0.02
VITS_MAX_FRAMES_PER_ID = 20     # the ceiling the smoke asserts
AUDIO_TEXTS = [
    "Hello there.",
    "The quick brown fox jumps over the lazy dog.",
    "Speech on the card: a voice drawn from a seed, read at sixteen "
    "kilohertz, one sentence after another, until the paragraph ends.",
]


def _speech_like(seconds: float, seed: int = 0) -> np.ndarray:
    """A voiced, amplitude-modulated tone with noise at 16 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.02 * rng.normal(size=t.size)).astype(np.float32)


def _multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "----chip-smoke-audio"
    out = b""
    for name, value in fields.items():
        out += f"--{boundary}\r\n".encode()
        if isinstance(value, bytes):
            out += (f'Content-Disposition: form-data; name="{name}"; '
                    'filename="a.wav"\r\nContent-Type: audio/wav\r\n\r\n'
                    ).encode() + value + b"\r\n"
        else:
            out += (f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
                    f"{value}\r\n").encode()
    return out + f"--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


def _post_raw(url: str, data: bytes, ctype: str,
              timeout: float = 600) -> tuple[int, bytes, str]:
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), r.headers.get("Content-Type", "")


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def phase_whisper_parity() -> dict:
    """Card = CPU for whisper on a small float32 preset with large-v3's
    mel bins and vocabulary (d_model 384, 6 heads, 4 + 4 layers): per
    chunk of a 35-s recording, encoder states within 1e-4 of their
    largest value and greedy token ids equal."""
    from localai_tpu_torch.audio import mel as tmel
    from localai_tpu_torch.models import whisper as twh

    cfg = twh.WhisperConfig.from_hf({**WHISPER_LARGE_V3_CONFIG,
                                     "d_model": 384,
                                     "encoder_attention_heads": 6,
                                     "encoder_layers": 4,
                                     "decoder_layers": 4,
                                     "encoder_ffn_dim": 1536,
                                     "max_target_positions": 96})
    params = twh.init_params(cfg, seed=21, device="cpu")
    cpu = twh.WhisperModel(cfg, params, device="cpu")
    card = twh.WhisperModel(cfg, _to(params, "cuda"), device="cuda")
    out = []
    for chunk in tmel.chunk_audio(_speech_like(35.0, 3)):
        err = _rel_err(card.encode_chunk(chunk), cpu.encode_chunk(chunk))
        ids_card = card.transcribe_chunk(chunk)
        ids_cpu = cpu.transcribe_chunk(chunk)
        if err > 1e-4 or ids_card != ids_cpu:
            raise AssertionError(f"whisper card != CPU: encoder {err}, ids "
                                 f"{ids_card[:12]} vs {ids_cpu[:12]}")
        out.append({"encoder_rel_err": err, "tokens": len(ids_card)})
    print("whisper_parity: " + json.dumps(out), flush=True)
    return {"chunks": out}


def _write_vits_voice(path, cfg, seed: int) -> None:
    """A VITS checkpoint dir: config.json, safetensors of seeded weights
    at ``VITS_STD``, a 38-symbol vocab.json, tokenizer_config.json."""
    import dataclasses

    from localai_tpu_torch.audio.vits import init_params
    from localai_tpu_torch.models.loader import write_checkpoint

    tensors = {k: torch.from_numpy(v)
               for k, v in init_params(cfg, seed, VITS_STD).items()}
    write_checkpoint(path, {"model_type": "vits",
                            **dataclasses.asdict(cfg)}, tensors)
    _write_json(Path(path) / "vocab.json",
                {ch: i for i, ch in enumerate(MMS_VOCAB)})
    _write_json(Path(path) / "tokenizer_config.json",
                {"do_lower_case": True, "add_blank": True,
                 "pad_token": "_"})


def phase_vits_parity(root: Path) -> dict:
    """Card = CPU for VITS at mms-tts-eng's widths from one checkpoint
    dir: waveforms within 1e-4 at zero noise and at the default noise
    scales (the draws come from the same CPU generator), and a
    multi-speaker copy conditioned on a ``SpeakerEncoder`` embedding
    (embedding within 1e-5, waveform within 1e-4)."""
    from localai_tpu_torch.audio import speaker as tsp
    from localai_tpu_torch.audio.vits import VitsConfig, load_hf_vits

    out = {}
    for sub, cfg in (("mms", VitsConfig()),
                     ("mms-speakers", VitsConfig(num_speakers=4,
                                                 speaker_embedding_size=256))):
        _write_vits_voice(root / sub, cfg, seed=31)
        card = load_hf_vits(root / sub, "cuda")
        cpu = load_hf_vits(root / sub, "cpu")
        emb = None
        if cfg.num_speakers > 1:
            ref = _speech_like(3.0, 9)
            e_card = tsp.SpeakerEncoder(device="cuda").embed(ref)
            e_cpu = tsp.SpeakerEncoder(device="cpu").embed(ref)
            if float(np.abs(e_card - e_cpu).max()) > 1e-5:
                raise AssertionError("speaker embedding card != CPU")
            emb = tsp.SpeakerEncoder(device="cpu").project(e_cpu, 256)
        for noise in (0.0, None):
            kw = {} if noise is None else {"noise_scale": noise,
                                           "noise_scale_duration": noise}
            a = card.synthesize(AUDIO_TEXTS[1], speaker_embedding=emb, **kw)
            b = cpu.synthesize(AUDIO_TEXTS[1], speaker_embedding=emb, **kw)
            err = (float(np.abs(a - b).max()) if a.shape == b.shape
                   else float("inf"))
            if not (np.isfinite(a).all() and err <= 1e-4):
                raise AssertionError(f"vits {sub} card != CPU: {a.shape} vs "
                                     f"{b.shape}, {err}")
            out[f"{sub}-{'zero' if noise == 0 else 'default'}-noise"] = {
                "max_abs_err": err, "samples": int(a.shape[0]),
                "frames": card.last_frames}
    print("vits_parity: " + json.dumps(out), flush=True)
    return out


def phase_musicgen_parity() -> dict:
    """Card = CPU for the MusicGen-class generator (the serving preset,
    seeded weights drawn on the CPU): greedy codes of 3 s equal, the
    EnCodec audio within 1e-4."""
    from localai_tpu_torch.audio.musicgen import MusicGenerator

    card, cpu = MusicGenerator(device="cuda"), MusicGenerator(device="cpu")
    text = "rain on a tin roof"
    c_card = card.generate_codes(text, 3.0, temperature=0.0)
    c_cpu = cpu.generate_codes(text, 3.0, temperature=0.0)
    if not torch.equal(c_card.cpu(), c_cpu):
        raise AssertionError("musicgen greedy codes card != CPU")
    a, b = card.decode(c_card), cpu.decode(c_cpu)
    err = float(np.abs(a - b).max())
    if err > 1e-4:
        raise AssertionError(f"musicgen audio card != CPU: {err}")
    rec = {"codes": list(c_card.shape), "audio_max_abs_err": err}
    print("musicgen_parity: " + json.dumps(rec), flush=True)
    return rec


def _draw_whisper(cfg, seed: int) -> dict:
    """Whisper weights in the port's init scheme (gains 1, 1-D leaves 0,
    the rest N(0, 0.02)), drawn on the card's generator."""
    from localai_tpu_torch.models import whisper as twh

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(name, shape):
        if name in twh._GAIN_NAMES:
            return torch.ones(shape, device="cuda")
        if len(shape) == 1:
            return torch.zeros(shape, device="cuda")
        return torch.randn(shape, generator=g, device="cuda") * 0.02

    return {n: ({k: mk(k, s) for k, s in v.items()} if isinstance(v, dict)
                else mk(n, v))
            for n, v in twh.param_shapes(cfg).items()}


def _timed(fn, store: list):
    """``fn`` wrapped: each call's CUDA-event ms (and result) appended."""
    def run(*args, **kwargs):
        ms, out = _events_ms(lambda: fn(*args, **kwargs))
        store.append((ms, out))
        return out
    return run


def _decode_profile(model, chunk, limit: int = 16) -> dict:
    """One chunk's KV-cached greedy decode, capped at ``limit`` tokens
    (the profiler's post-processing grows with its ~900 events a token),
    under torch.profiler: device busy time over the host wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from localai_tpu_torch.models import whisper as twh
    from localai_tpu_torch.utils.device import full_f32

    cfg = model.cfg
    enc = model.encode_chunk(chunk)
    prompt = [cfg.sot, cfg.lang_base, cfg.token_transcribe,
              cfg.token_notimestamps]
    with torch.inference_mode(), full_f32():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ids = twh.decode_greedy(cfg, model.params, prompt, enc, limit)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in ev) / 1e6
    return {"tokens": len(ids), "wall_ms_per_token": wall * 1e3 / len(ids),
            "device_busy_ms_per_token": busy * 1e3 / len(ids),
            "device_idle_share": max(0.0, 1 - busy / wall),
            "launches_per_token": sum(e.count for e in ev) / len(ids)}


def phase_serve_audio(card: str, root: Path) -> dict:
    """The audio routes through the port's server on the card, from one
    models dir: ``whisper-large-v3-f32`` (openai/whisper-large-v3's
    widths, the depth of ``SMOKE_LAYERS``, seeded weights written as a float16 checkpoint with
    a 50257-id byte-level BPE tokenizer.json, loaded from a ``backend:
    whisper`` YAML and widened to float32) answers multipart
    transcriptions of a 5-s (verbose_json), a 30-s and a 65-s (3 chunks)
    recording; ``vits-mms-tts-eng`` answers three ``/v1/audio/speech``
    requests, a multi-speaker copy one with a reference voice from its
    ``audio_path`` (the cloning path), the Elevenlabs route and ``/tts``
    on a ``debug:`` model the parametric voice, and
    ``/v1/sound-generation`` 3 s and 10 s. Prints load s, peak memory,
    encoder ms a chunk and decode ms a token (CUDA events around the
    served calls), tokens a chunk, real-time factors (audio s / wall s)
    and the device idle share of a chunk's decode (torch.profiler)."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.audio import wav as twav
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models import whisper as twh
    from localai_tpu_torch.models.loader import write_safetensors
    from localai_tpu_torch.models.manager import ModelManager

    models = root / "models"
    models.mkdir()
    hf = {**WHISPER_LARGE_V3_CONFIG, "encoder_layers": SMOKE_LAYERS[
        "whisper"], "decoder_layers": SMOKE_LAYERS["whisper"]}
    cfg = twh.WhisperConfig.from_hf(hf)
    t0 = time.monotonic()
    params = _draw_whisper(cfg, seed=41)
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    ckpt = root / "whisper-large-v3"
    ckpt.mkdir()
    getters = twh.hf_tensors(cfg, params)
    nbytes = write_safetensors(ckpt / "model.safetensors", [
        (name, tuple(get().shape), torch.float16, get)
        for name, get in getters.items()])
    _write_json(ckpt / "config.json", hf)
    _write_json(ckpt / "tokenizer.json", small_bpe_spec(50257))
    del params, getters
    write_s = time.monotonic() - t0
    (root / "voices").mkdir()
    (root / "voices" / "alice.wav").write_bytes(
        twav.write_wav(_speech_like(3.0, 9)))
    write_models_dir(models, {
        "stt": f"name: {WHISPER}\nbackend: whisper\nmodel: {ckpt}\n",
        "mms": f"name: {VITS}\nbackend: vits\nmodel: {root / 'mms'}\n",
        "clone": (f"name: {VITS_CLONE}\nbackend: vits\nmodel: "
                  f"{root / 'mms-speakers'}\ntts:\n  audio_path: "
                  f"{root / 'voices'}\n  voice: alice\n"),
        "speak": "name: speak\nbackend: tts\nmodel: debug:tts\n"})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=str(models), device="cuda"),
                           loader)
    server = APIServer(manager, "127.0.0.1", 0).start()
    enc_times: list = []
    dec_times: list = []
    orig_enc, orig_dec = twh.WhisperModel.encode_chunk, twh.decode_greedy
    try:
        t0 = time.monotonic()
        sm = manager.get_whisper(WHISPER)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        load_peak = torch.cuda.max_memory_allocated() / 1e9
        twh.WhisperModel.encode_chunk = _timed(orig_enc, enc_times)
        twh.decode_greedy = _timed(orig_dec, dec_times)
        url = server.url
        stt = []
        for seconds, fmt, chunks in ((5.0, "verbose_json", 1),
                                     (30.0, "json", 1), (65.0, "text", 3)):
            wav = twav.write_wav(_speech_like(seconds, int(seconds)))
            data, ctype = _multipart({"file": wav, "model": WHISPER,
                                      "response_format": fmt})
            n_dec = len(dec_times)
            t0 = time.monotonic()
            status, body, rtype = _post_raw(
                url + "/v1/audio/transcriptions", data, ctype)
            wall = time.monotonic() - t0
            if fmt == "text":
                ok = rtype.startswith("text/plain") and body.endswith(b"\n")
            else:
                out = json.loads(body)
                keys = ({"task", "duration", "text", "segments"}
                        if fmt == "verbose_json" else {"text", "segments"})
                ok = set(out) == keys and len(out["segments"]) == chunks
            toks = [len(ids) for _, ids in dec_times[n_dec:]]
            if status != 200 or not ok or len(toks) != chunks or max(
                    toks) > cfg.max_target_positions - 4:
                raise AssertionError(f"{WHISPER}: {seconds} s {fmt}: "
                                     f"{status} {body[:200]!r} {toks}")
            stt.append({"audio_s": seconds, "format": fmt, "wall_s": wall,
                        "chunks": chunks, "tokens_per_chunk": toks,
                        "real_time_factor": seconds / wall})
        twh.WhisperModel.encode_chunk, twh.decode_greedy = orig_enc, orig_dec
        enc_ms = [ms for ms, _ in enc_times]
        dec_ms_tok = [ms / max(len(ids), 1) for ms, ids in dec_times]
        t0 = time.monotonic()
        prof = _decode_profile(sm.model, _speech_like(30.0, 30))
        prof["profile_s"] = time.monotonic() - t0
        whisper_rec = {
            "params": n_params, "checkpoint_gb_f16": nbytes / 1e9,
            "write_s": write_s, "load_s": load_s,
            "peak_gb_after_load": load_peak,
            "encoder_ms_per_chunk": enc_ms,
            "decode_ms_per_token": dec_ms_tok, "requests": stt,
            "decode_profile": prof}
        manager.shutdown_model(WHISPER, force=True)
        del sm
        gc.collect()
        torch.cuda.empty_cache()
        tts = []
        for path, body in (
                [("/v1/audio/speech", {"model": VITS, "input": t})
                 for t in AUDIO_TEXTS]
                + [("/v1/text-to-speech/alice", {"text": AUDIO_TEXTS[1]}),
                   ("/v1/audio/speech", {"model": VITS_CLONE,
                                         "input": AUDIO_TEXTS[1]}),
                   ("/tts", {"model": "speak", "input": AUDIO_TEXTS[1]}),
                   ("/v1/sound-generation", {"text": "rain on a tin roof",
                                             "duration_seconds": 3}),
                   ("/v1/sound-generation", {"text": "wind in the trees",
                                             "duration_seconds": 10})]):
            t0 = time.monotonic()
            r = _post(url + path, body)
            audio = twav.read_wav(r.read())
            wall = time.monotonic() - t0
            rec = {"path": path, "model": body.get("model", ""),
                   "ms": wall * 1e3, "audio_s": audio.size / 16000,
                   "real_time_factor": audio.size / 16000 / wall}
            vits_name = body.get("model") if body.get("model") in (
                VITS, VITS_CLONE) else None
            if vits_name:
                voice = manager.get_vits(vits_name).model
                ids = len(voice.tokenizer.encode(body["input"]))
                rec.update(frames=voice.last_frames, ids=ids)
                if voice.last_frames > VITS_MAX_FRAMES_PER_ID * ids:
                    raise AssertionError(f"{vits_name}: {voice.last_frames}"
                                         f" frames for {ids} ids")
            if (r.headers.get("Content-Type") != "audio/wav"
                    or not np.isfinite(audio).all() or audio.size < 1600):
                raise AssertionError(f"{path}: {r.headers} {audio.size}")
            tts.append(rec)
        want = [3.0, 10.0]
        got = [x["audio_s"] for x in tts if "sound" in x["path"]]
        if got != want:
            raise AssertionError(f"sound-generation lengths {got} != {want}")
        return {"whisper": whisper_rec, "speech": tts,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        twh.WhisperModel.encode_chunk, twh.decode_greedy = orig_enc, orig_dec
        server.shutdown()
        manager.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


def phase_audio(card: str) -> dict:
    """The audio group: card = CPU for whisper, VITS and MusicGen, then
    the audio serve; K1–K5 launch never (every count zeroed first). Its
    command time is printed."""
    kernels = _all_kernels()
    for w in kernels.values():
        w.launches = 0
    t0 = time.monotonic()
    root = Path(_scratch_dir("audio-", 5_000_000_000))
    parity, phase_s = {}, {}
    try:
        for name, run in (("whisper", phase_whisper_parity),
                          ("vits", lambda: phase_vits_parity(root)),
                          ("musicgen", phase_musicgen_parity),
                          ("serve", lambda: phase_serve_audio(card, root))):
            t1 = time.monotonic()
            parity[name] = run()
            phase_s[name] = time.monotonic() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _no_launches("the audio group", kernels)
    serve = parity.pop("serve")
    rec = {"card": card, "parity": parity, **serve, "phase_s": phase_s,
           "k1_k5_launches": 0, "group_s": time.monotonic() - t0}
    print("audio: " + json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# image generation (the SD-1.x / SDXL UNet pipeline)

SDXL_BASE = "sdxl-base-1.0-bf16"
SD15_LORA = "sd-1.5-bf16-lora"
SD15_CN = "sd-1.5-bf16-controlnet"
# the request sizes and steps of the image serves
SDXL_SIZE, SD15_SIZE, IMAGE_STEPS = 1024, 512, 20
CLIP_VOCAB = 49408
_CLIP_DOWN = ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"]
# stabilityai/stable-diffusion-xl-base-1.0's unet/, vae/, text_encoder/
# and text_encoder_2/ config.json, as published
SDXL_UNET_CONFIG = {
    "_class_name": "UNet2DConditionModel", "act_fn": "silu",
    "addition_embed_type": "text_time", "addition_embed_type_num_heads": 64,
    "addition_time_embed_dim": 256, "attention_head_dim": [5, 10, 20],
    "block_out_channels": [320, 640, 1280], "center_input_sample": False,
    "class_embed_type": None, "conv_in_kernel": 3, "conv_out_kernel": 3,
    "cross_attention_dim": 2048,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                         "CrossAttnDownBlock2D"],
    "downsample_padding": 1, "flip_sin_to_cos": True, "freq_shift": 0,
    "in_channels": 4, "layers_per_block": 2,
    "mid_block_type": "UNetMidBlock2DCrossAttn", "norm_eps": 1e-05,
    "norm_num_groups": 32, "num_attention_heads": None, "out_channels": 4,
    "projection_class_embeddings_input_dim": 2816, "sample_size": 128,
    "transformer_layers_per_block": [1, 2, 10],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                       "UpBlock2D"],
    "use_linear_projection": True}
SDXL_VAE_CONFIG = {
    "_class_name": "AutoencoderKL", "act_fn": "silu",
    "block_out_channels": [128, 256, 512, 512],
    "down_block_types": ["DownEncoderBlock2D"] * 4, "force_upcast": True,
    "in_channels": 3, "latent_channels": 4, "layers_per_block": 2,
    "norm_num_groups": 32, "out_channels": 3, "sample_size": 1024,
    "scaling_factor": 0.13025, "up_block_types": ["UpDecoderBlock2D"] * 4}
CLIP_L_CONFIG = {
    "architectures": ["CLIPTextModel"], "attention_dropout": 0.0,
    "bos_token_id": 0, "dropout": 0.0, "eos_token_id": 2,
    "hidden_act": "quick_gelu", "hidden_size": 768,
    "initializer_factor": 1.0, "initializer_range": 0.02,
    "intermediate_size": 3072, "layer_norm_eps": 1e-05,
    "max_position_embeddings": 77, "model_type": "clip_text_model",
    "num_attention_heads": 12, "num_hidden_layers": 12, "pad_token_id": 1,
    "projection_dim": 768, "torch_dtype": "float16", "vocab_size": 49408}
SDXL_TEXT2_CONFIG = {
    **CLIP_L_CONFIG, "architectures": ["CLIPTextModelWithProjection"],
    "hidden_act": "gelu", "hidden_size": 1280, "intermediate_size": 5120,
    "num_attention_heads": 20, "num_hidden_layers": 32,
    "projection_dim": 1280}
# stable-diffusion-v1-5/stable-diffusion-v1-5's unet/ and vae/ (its
# text_encoder/ is CLIP_L_CONFIG), and lllyasviel/sd-controlnet-canny's
SD15_UNET_CONFIG = {
    "_class_name": "UNet2DConditionModel", "act_fn": "silu",
    "attention_head_dim": 8, "block_out_channels": [320, 640, 1280, 1280],
    "center_input_sample": False, "cross_attention_dim": 768,
    "down_block_types": _CLIP_DOWN, "downsample_padding": 1,
    "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
    "layers_per_block": 2, "mid_block_scale_factor": 1, "norm_eps": 1e-05,
    "norm_num_groups": 32, "out_channels": 4, "sample_size": 64,
    "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3}
SD15_VAE_CONFIG = {**SDXL_VAE_CONFIG, "sample_size": 512,
                   "scaling_factor": 0.18215}
SD15_VAE_CONFIG.pop("force_upcast")
CANNY_CONFIG = {
    "_class_name": "ControlNetModel", "act_fn": "silu",
    "attention_head_dim": 8, "block_out_channels": [320, 640, 1280, 1280],
    "class_embed_type": None,
    "conditioning_embedding_out_channels": [16, 32, 96, 256],
    "controlnet_conditioning_channel_order": "rgb",
    "cross_attention_dim": 768, "down_block_types": _CLIP_DOWN,
    "downsample_padding": 1, "flip_sin_to_cos": True, "freq_shift": 0,
    "in_channels": 4, "layers_per_block": 2, "mid_block_scale_factor": 1,
    "norm_eps": 1e-05, "norm_num_groups": 32, "num_class_embeds": None,
    "only_cross_attention": False,
    "projection_class_embeddings_input_dim": None,
    "resnet_time_scale_shift": "default", "upcast_attention": False,
    "use_linear_projection": False}
IMAGE_PROMPTS = ["a lighthouse on a cliff at dusk, oil painting",
                 "a red fox in fresh snow|blurry, low quality"]


def _clip_fill(vocab: dict, merges: list, limit: int) -> None:
    """Merges of two tokens in a fixed order (``_fill_merges``'s
    diagonals) until the vocabulary holds ``limit``: a head is a token
    without ``</w>`` (a word ends only once)."""
    toks = list(vocab)
    heads = [t for t in toks if not t.endswith("</w>")]
    s = 0
    while len(vocab) < limit:
        for i in range(max(0, s - len(toks) + 1), min(s + 1, len(heads))):
            a, b = heads[i], toks[s - i]
            new = a + b
            if new in vocab:
                continue
            merges.append(f"{a} {b}")
            vocab[new] = len(vocab)
            toks.append(new)
            if not new.endswith("</w>"):
                heads.append(new)
            if len(vocab) == limit:
                break
        s += 1


def clip_vocab(size: int) -> tuple[dict, list]:
    """A CLIP-format vocabulary of ``size`` ids: the 256 byte symbols,
    their ``</w>`` forms, the merges a stdlib BPE learns over
    ``TOKENIZER_CORPUS`` (lowercased, split on CLIP's pattern), merges of
    earlier tokens up to ``size - 2``, then <|startoftext|> and
    <|endoftext|> as the last two ids, as in CLIP's vocab.json."""
    from localai_tpu_torch.utils.hf_tokenizer import (
        BYTE_CHAR,
        CLIP_PATTERN,
        onig_regex,
    )

    syms = [BYTE_CHAR[b] for b in range(256)]
    vocab = {s: i for i, s in enumerate(syms + [s + "</w>" for s in syms])}
    words: dict = {}
    for w in onig_regex(CLIP_PATTERN).findall(TOKENIZER_CORPUS.lower()):
        chars = [BYTE_CHAR[b] for b in w.encode("utf-8")]
        key = tuple(chars[:-1] + [chars[-1] + "</w>"])
        words[key] = words.get(key, 0) + 1
    merges: list = []
    _train_bpe(words, vocab, merges, size - 2)
    _clip_fill(vocab, merges, size - 2)
    vocab["<|startoftext|>"] = size - 2
    vocab["<|endoftext|>"] = size - 1
    return vocab, merges


def write_clip_tokenizer(d, pad: Optional[str] = None) -> None:
    """``vocab.json``, ``merges.txt`` and ``tokenizer_config.json`` of a
    CLIP tokenizer directory of ``CLIP_VOCAB`` ids (``pad`` "!" as SDXL's
    tokenizer_2)."""
    vocab, merges = clip_vocab(CLIP_VOCAB)
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    _write_json(d / "vocab.json", vocab)
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                  + "\n", encoding="utf-8")
    _write_json(d / "tokenizer_config.json", {
        "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "pad_token": pad or "<|endoftext|>",
        "model_max_length": 77})


def nfkc_charsmap_table() -> dict:
    """The smoke's ``precompiled_charsmap`` content: the NFKC mappings of
    full-width forms, circled and super/subscript digits, ligatures,
    compatibility jamo, Roman numerals and wide spaces, and ``e`` U+0301
    → U+00E9."""
    import unicodedata

    cps = (list(range(0xFF01, 0xFF5F)) + list(range(0x2460, 0x2474))
           + list(range(0x2070, 0x209D)) + list(range(0xFB00, 0xFB07))
           + list(range(0x3131, 0x318F)) + list(range(0x2160, 0x2180))
           + [0x00A0, 0x3000, 0x2126, 0x212B, 0x00BD, 0x2026])
    table = {}
    for cp in cps:
        n = unicodedata.normalize("NFKC", chr(cp))
        if n != chr(cp):
            table[chr(cp)] = n
    table["é"] = "é"
    return table


def t5_unigram_spec(pieces: int = 32000, extra_ids: int = 100) -> dict:
    """A T5-format ``tokenizer.json`` built by the port's own writers
    (no ``tokenizers`` on the card's machine): ``pieces`` Unigram pieces
    (<pad>, </s>, <unk>; every character of ``TOKENIZER_CORPUS``,
    printable ASCII and "▁"; the corpus's "▁"-prefixed substrings up to 8
    characters scored by log frequency; then joins of earlier pieces in a
    fixed order, scored below them), ``extra_ids`` ``<extra_id_N>``
    tokens, ``nfkc_charsmap_table`` as the ``Precompiled`` charsmap, and
    ``T5Converter``'s normalizer, Metaspace and ``$A </s>`` template."""
    import math
    import unicodedata

    from localai_tpu_torch.utils import spm

    text = unicodedata.normalize("NFKC", TOKENIZER_CORPUS)
    counts: dict = {}
    for w in text.split():
        w = "▁" + w
        for i in range(len(w)):
            for j in range(i + 1, min(len(w), i + 8) + 1):
                counts[w[i:j]] = counts.get(w[i:j], 0) + 1
    total = sum(counts.values())
    chars = sorted(set(text) - set(" \n\t") | set(map(chr, range(33, 127)))
                   | {"▁"})
    scored = {c: math.log((counts.get(c, 0) + 1) / total) for c in chars}
    for s, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(scored) >= pieces - 3:
            break
        if n > 1 and s not in scored:
            scored[s] = math.log(n / total)
    base = sorted(scored, key=lambda s: (-scored[s], s))
    low = min(scored.values()) - 1.0
    k = 0
    while len(scored) < pieces - 3:
        a, b = base[k % len(base)], base[(k // len(base) + 1) % len(base)]
        k += 1
        if a + b not in scored and "▁" not in b:
            scored[a + b] = low - 1e-4 * len(scored)
    model = spm.ModelProto(
        pieces=[spm.Piece("<pad>", 0.0, spm.CONTROL),
                spm.Piece("</s>", 0.0, spm.CONTROL),
                spm.Piece("<unk>", 0.0, spm.UNKNOWN)]
        + [spm.Piece(s, sc) for s, sc in scored.items()],
        unk_id=2,
        precompiled_charsmap=spm.charsmap_bytes(nfkc_charsmap_table()))
    spec = spm.t5_tokenizer_spec(model, extra_ids=extra_ids)
    n = len(model.pieces)
    spec["added_tokens"].append(
        {"id": 2, "content": "<unk>", "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True})
    spec["added_tokens"] += [
        {"id": n + extra_ids - 1 - i, "content": f"<extra_id_{i}>",
         "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True} for i in range(extra_ids)]
    spec["added_tokens"].sort(key=lambda t: t["id"])
    return spec


def write_t5_tokenizer(d, pieces: int = 32000, extra_ids: int = 100) -> int:
    """FLUX's ``tokenizer_2/``: ``t5_unigram_spec`` as ``tokenizer.json``
    and a ``tokenizer_config.json`` naming ``T5TokenizerFast``. Returns
    the vocabulary size."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    spec = t5_unigram_spec(pieces, extra_ids)
    _write_json(d / "tokenizer.json", spec)
    _write_json(d / "tokenizer_config.json", {
        "tokenizer_class": "T5TokenizerFast", "extra_ids": extra_ids,
        "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
        "model_max_length": 512})
    return len(spec["model"]["vocab"])


def _perturbed(tree, seed: int, std: float = 0.05):
    """Every leaf plus seeded noise, so gains and biases are not 1 and 0
    (drawn on the CPU; float32)."""
    from localai_tpu_torch.image.loader import map_tree

    g = torch.Generator().manual_seed(seed)
    return map_tree(tree, lambda t: t.float()
                    + std * torch.randn(t.shape, generator=g))


def _image_layouts():
    """Debug-width float32 layouts of the card = CPU checks: SD-1 (1x1
    proj_in, one encoder) and SDXL (no attention at level 0, 1 and 2
    blocks by level, heads per level, two encoders, text_time)."""
    from localai_tpu_torch.image.clip import CLIPTextConfig
    from localai_tpu_torch.image.unet import UNetConfig
    from localai_tpu_torch.image.vae import VAEConfig

    clip1 = CLIPTextConfig(vocab_size=300, hidden_size=48,
                           intermediate_size=96, num_layers=3, num_heads=4,
                           max_length=12, eos_token_id=299, dtype="float32")
    clip2 = CLIPTextConfig(vocab_size=300, hidden_size=32,
                           intermediate_size=64, num_layers=3, num_heads=2,
                           max_length=12, eos_token_id=299,
                           activation="gelu", projection_dim=24,
                           dtype="float32")
    vae = VAEConfig(base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                    dtype="float32")
    return {
        "sd1": dict(unet=UNetConfig(
            model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attn_levels=(0, 1), transformer_depth=2, num_heads=4,
            context_dim=48, dtype="float32"), vae=vae, text=clip1),
        "sdxl": dict(unet=UNetConfig(
            model_channels=32, channel_mult=(1, 2, 2), num_res_blocks=1,
            attn_levels=(1, 2), depth_per_level=(1, 1, 2),
            heads_per_level=(2, 2, 4), context_dim=80, addition_embed=True,
            addition_time_embed_dim=8, addition_in_dim=72, dtype="float32"),
            vae=vae, text=clip1, text2=clip2)}


def phase_image_parity() -> dict:
    """Card = CPU at debug widths in float32 (TF32 off), on the SD-1 and
    the SDXL layout: the UNet's eps (with ControlNet residuals on SD-1),
    the VAE's decode and encode, CLIP's states and pooled output within
    1e-4 of the largest output; 4-step ``generate`` with euler_a and
    dpmpp_2m (a ControlNet and a control image on SD-1's dpmpp_2m run):
    latents within 1e-4, uint8 pixels within 1."""
    from localai_tpu_torch.image import clip as tclip
    from localai_tpu_torch.image import controlnet as tcn
    from localai_tpu_torch.image import unet as tunet
    from localai_tpu_torch.image import vae as tvae
    from localai_tpu_torch.image.loader import map_tree
    from localai_tpu_torch.image.pipeline import DiffusionPipeline
    from localai_tpu_torch.utils.device import full_f32
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    out = {}
    rng = np.random.default_rng(61)
    for layout, cfgs in _image_layouts().items():
        ucfg = cfgs["unet"]
        trees = {"unet": tunet.init_params(ucfg, 1, "cpu"),
                 "vae": tvae.init_params(cfgs["vae"], 2, "cpu"),
                 "text": tclip.init_params(cfgs["text"], 3, "cpu")}
        if "text2" in cfgs:
            trees["text2"] = tclip.init_params(cfgs["text2"], 4, "cpu")
        else:
            trees["cn"] = tcn.init_params(ucfg, 5, "cpu",
                                          cond_channels=(8, 16))
        trees = {k: _perturbed(v, 10 + i)
                 for i, (k, v) in enumerate(trees.items())}
        dev = {d: {k: map_tree(v, lambda t, d=d: t.to(d))
                   for k, v in trees.items()} for d in ("cuda", "cpu")}
        lat = torch.from_numpy(rng.normal(size=(2, 4, 16, 16)).astype(
            np.float32))
        ts = torch.tensor([999.0, 17.5])
        ctx = torch.from_numpy(rng.normal(size=(2, 7, ucfg.context_dim))
                               .astype(np.float32))
        extra = {}
        if ucfg.addition_embed:
            extra = {"pooled_text": torch.from_numpy(rng.normal(
                size=(2, 24)).astype(np.float32)),
                "time_ids": torch.tensor([[64.0, 48, 0, 0, 64, 48]] * 2)}
        ids = torch.from_numpy(rng.integers(1, 298, (2, 12)))
        ids[:, -2:] = 299
        img = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 32)).astype(
            np.float32))
        errs: dict = {}
        res = {}
        with torch.inference_mode(), full_f32():
            for d in ("cuda", "cpu"):
                p = dev[d]
                mv = lambda t, d=d: t.to(d)  # noqa: E731
                ex = {k: mv(v) for k, v in extra.items()}
                r = {"eps": tunet.forward(ucfg, p["unet"], mv(lat), mv(ts),
                                          mv(ctx), **ex),
                     "decode": tvae.decode(cfgs["vae"], p["vae"],
                                           mv(lat[:1])),
                     "encode": tvae.encode(cfgs["vae"], p["vae"], mv(img)),
                     "clip": tclip.forward(cfgs["text"], p["text"], mv(ids),
                                           clip_skip=2)}
                if "cn" in p:
                    cimg = mv(torch.rand((2, 3, 32, 32),
                                         generator=torch.Generator()
                                         .manual_seed(7)))
                    down, mid = tcn.forward(ucfg, p["cn"], mv(lat), mv(ts),
                                            mv(ctx), cimg, 0.8)
                    r["eps_controlnet"] = tunet.forward(
                        ucfg, p["unet"], mv(lat), mv(ts), mv(ctx),
                        down_residuals=down, mid_residual=mid)
                if "text2" in p:
                    h, pooled = tclip.encode_sdxl(cfgs["text2"], p["text2"],
                                                  mv(ids))
                    r["clip2"], r["pooled"] = h, pooled
                res[d] = r
        for k in res["cpu"]:
            errs[k] = _rel_err(res["cuda"][k], res["cpu"][k])
        pipes = {}
        for d in ("cuda", "cpu"):
            p = dev[d]
            pipes[d] = DiffusionPipeline(
                ucfg, p["unet"], cfgs["vae"], p["vae"], cfgs["text"],
                p["text"], ByteTokenizer(), device=d,
                text2_cfg=cfgs.get("text2"), text2_params=p.get("text2"))
            if "cn" in p:
                pipes[d].controlnet_cfg = ucfg
                pipes[d].controlnet_params = p["cn"]
        ctrl = rng.integers(0, 256, (80, 48, 3), np.uint8)
        for sched in ("euler_a", "dpmpp_2m"):
            kw = dict(steps=4, seed=11, scheduler=sched, width=64,
                      height=64, negative_prompt="blurry")
            if layout == "sd1" and sched == "dpmpp_2m":
                kw.update(control_image=ctrl, control_scale=0.7)
            a = pipes["cuda"].generate("a red fox", **kw)
            b = pipes["cpu"].generate("a red fox", **kw)
            errs[f"latents-{sched}"] = _rel_err(a.latents, b.latents)
            errs[f"pixels-{sched}"] = int(np.abs(
                a.image.astype(int) - b.image.astype(int)).max())
        bad = {k: v for k, v in errs.items()
               if v > (1 if k.startswith("pixels") else 1e-4)}
        if bad:
            raise AssertionError(f"image parity ({layout}): card != CPU: "
                                 f"{bad}")
        out[layout] = errs
    print("image parity: " + json.dumps(out), flush=True)
    return out


def _draw_pipeline(root: Path, configs: dict, seed: int) -> dict:
    """Seeded bf16 weights drawn on the card at the configs' widths,
    written as a diffusers directory with the published config.json
    files and CLIP tokenizers; returns params, bytes and seconds."""
    from localai_tpu_torch.image import clip as tclip
    from localai_tpu_torch.image import unet as tunet
    from localai_tpu_torch.image import vae as tvae
    from localai_tpu_torch.image.clip import CLIPTextConfig
    from localai_tpu_torch.image.loader import write_diffusers_pipeline
    from localai_tpu_torch.image.unet import UNetConfig
    from localai_tpu_torch.image.vae import VAEConfig

    t0 = time.monotonic()
    ucfg = UNetConfig.from_hf(configs["unet"])
    vcfg = VAEConfig.from_hf(configs["vae"])
    pairs = {"unet": (ucfg, tunet.init_params(ucfg, seed, "cuda")),
             "vae": (vcfg, tvae.init_params(vcfg, seed + 1, "cuda"))}
    subdirs = {"unet": "unet", "vae": "vae", "text": "text_encoder",
               "text2": "text_encoder_2"}
    for key in ("text", "text2"):
        if key in configs:
            c = CLIPTextConfig.from_hf(configs[key])
            pairs[key] = (c, tclip.init_params(c, seed + 2 + len(pairs),
                                               "cuda"))
    n_params = {k: sum(t.numel() for t in _leaves(p))
                for k, (_, p) in pairs.items()}
    nbytes = write_diffusers_pipeline(root, dtype="bfloat16", **pairs)
    for key, sub in subdirs.items():
        if key in configs:
            _write_json(root / sub / "config.json", configs[key])
    write_clip_tokenizer(root / "tokenizer")
    if "text2" in configs:
        write_clip_tokenizer(root / "tokenizer_2", pad="!")
    del pairs
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "params_total": sum(n_params.values()),
            "checkpoint_gb": nbytes / 1e9,
            "write_s": time.monotonic() - t0}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _step_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall, the device's
    busy time and idle share, and the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in ev) / 1e6
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "device_idle_share": max(0.0, 1 - busy / wall),
            "launches": sum(e.count for e in ev)}


def _image_request(url: str, body: dict) -> tuple[dict, float]:
    t0 = time.monotonic()
    with _post(url + "/v1/images/generations", body) as r:
        out = json.loads(r.read())
    return out, time.monotonic() - t0


def _check_png(data: bytes, size: int) -> None:
    from localai_tpu_torch.utils import png

    img = png.decode(data)
    if img.shape != (size, size, 3):
        raise AssertionError(f"PNG of shape {img.shape}, not "
                             f"{(size, size, 3)}")


def _timed_pipeline(pipe, times: dict) -> None:
    """CUDA-event times of a pipeline's text encode, UNet steps and VAE
    decode, and the latents of each image (instance wrappers)."""
    for name in ("_prepare_cond", "_unet_step", "_decode", "generate"):
        store = times.setdefault(name, [])
        setattr(pipe, name, _timed(getattr(pipe, name), store))


def _times_record(times: dict, walls: list) -> dict:
    step = [ms for ms, _ in times["_unet_step"]]
    lat = [r.latents for _, r in times["generate"]]
    if not all(bool(torch.isfinite(x).all()) for x in lat):
        raise AssertionError("latents are not finite")
    return {"text_encode_ms": [ms for ms, _ in times["_prepare_cond"]],
            "unet_ms_per_step": [min(step), float(np.median(step)),
                                 max(step)],
            "unet_steps": len(step),
            "vae_decode_ms": [ms for ms, _ in times["_decode"]],
            "wall_s_per_image": walls,
            "images_per_minute": 60.0 / float(np.median(walls))}


def phase_serve_sdxl(card: str, root: Path) -> dict:
    """``sdxl-base-1.0-bf16``: SDXL base 1.0's widths and depth (its
    published config.json files), seeded bf16 weights drawn on the card and
    written as a diffusers directory, served from a ``backend: diffusers``
    YAML through the HTTP server: 1024x1024, 20 steps, the default
    scheduler, ``b64_json``, then one ``url`` request fetched back. One
    full-width UNet step in bf16 against the same step in float32 (TF32
    off) within 2e-2 of the largest output, and one CFG step profiled."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.image import unet as tunet
    from localai_tpu_torch.image.loader import map_tree
    from localai_tpu_torch.models.manager import ModelManager

    ckpt = root / "sdxl-base-1.0"
    rec = _draw_pipeline(ckpt, {"unet": SDXL_UNET_CONFIG,
                                "vae": SDXL_VAE_CONFIG,
                                "text": CLIP_L_CONFIG,
                                "text2": SDXL_TEXT2_CONFIG}, seed=71)
    models = root / "models-sdxl"
    write_models_dir(models, {SDXL_BASE: f"name: {SDXL_BASE}\nbackend: "
                              f"diffusers\nmodel: {ckpt}\n"})
    torch.cuda.reset_peak_memory_stats()
    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=str(models), device="cuda",
                                     image_path=str(root / "images")),
                           loader)
    server = APIServer(manager, "127.0.0.1", 0).start()
    try:
        t0 = time.monotonic()
        sm = manager.get_image(SDXL_BASE)
        torch.cuda.synchronize()
        rec["load_s"] = time.monotonic() - t0
        rec["peak_gb_after_load"] = torch.cuda.max_memory_allocated() / 1e9
        pipe = sm.pipeline
        times: dict = {}
        _timed_pipeline(pipe, times)
        walls = []
        body = {"model": SDXL_BASE, "prompt": IMAGE_PROMPTS[0],
                "size": f"{SDXL_SIZE}x{SDXL_SIZE}", "step": IMAGE_STEPS,
                "seed": 1, "response_format": "b64_json"}
        out, wall = _image_request(server.url, body)
        walls.append(wall)
        _check_png(base64.b64decode(out["data"][0]["b64_json"]), SDXL_SIZE)
        out, wall = _image_request(server.url, {
            **body, "prompt": IMAGE_PROMPTS[1], "seed": 2,
            "response_format": "url"})
        walls.append(wall)
        with urllib.request.urlopen(out["data"][0]["url"], timeout=60) as r:
            if r.headers.get("Content-Type") != "image/png":
                raise AssertionError(f"url answer: {r.headers}")
            _check_png(r.read(), SDXL_SIZE)
        rec.update(_times_record(times, walls))
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # one CFG step, profiled (the served pipeline's own call)
        lat = SDXL_SIZE // pipe.vae_cfg.downscale
        g = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((1, 4, lat, lat), generator=g, device="cuda")
        with torch.inference_mode():
            cond = pipe._prepare_cond(IMAGE_PROMPTS[0], "", SDXL_SIZE,
                                      SDXL_SIZE)
            rec["unet_step_profile"] = _step_profile(
                lambda: pipe._unet_step(x, 14.6, 999.0, cond, 7.0))
            # bf16 against float32 on one full-width step (batch 1)
            ucfg = pipe.unet_cfg
            ctx = cond["context"][1:]
            kw = {"pooled_text": cond["pooled"][1:],
                  "time_ids": cond["time_ids"][1:]}
            ts = torch.tensor([500.0], device="cuda")
            eps16 = tunet.forward(ucfg, pipe.unet_params, x, ts, ctx, **kw)
            p32 = map_tree(pipe.unet_params, lambda t: t.float())
            cfg32 = dataclasses.replace(ucfg, dtype="float32")
            eps32 = tunet.forward(cfg32, p32, x, ts, ctx, **kw)
            del p32
        err = _rel_err(eps16, eps32)
        rec["bf16_vs_f32_step_rel_err"] = err
        if not err <= 2e-2:
            raise AssertionError(f"{SDXL_BASE}: a bf16 UNet step is {err} "
                                 "of the largest output from float32")
        return rec
    finally:
        server.shutdown()
        manager.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


def _lora_tensors(ucfg, tcfg, rank: int = 8, seed: int = 0) -> list:
    """A rank-``rank`` kohya LoRA over every UNet attention projection,
    the first ResBlock conv of each down level, and the text encoder's
    q/k/v/out projections (entries for ``write_safetensors``)."""
    g = torch.Generator().manual_seed(seed)
    mods = []
    mc = ucfg.model_channels
    for lvl in ucfg.attn_levels:
        ch = mc * ucfg.channel_mult[lvl]
        for j in range(ucfg.num_res_blocks):
            for a, kv in (("attn1", ch), ("attn2", ucfg.context_dim)):
                base = (f"unet_down_blocks_{lvl}_attentions_{j}_"
                        f"transformer_blocks_0_{a}")
                mods += [(f"{base}_to_q", ch, ch, 0),
                         (f"{base}_to_k", kv, ch, 0),
                         (f"{base}_to_v", kv, ch, 0),
                         (f"{base}_to_out_0", ch, ch, 0)]
        cin = mc * (ucfg.channel_mult[lvl - 1] if lvl else 1)
        mods.append((f"unet_down_blocks_{lvl}_resnets_0_conv1", cin, ch, 3))
    for i in range(tcfg.num_layers):
        for p in ("q", "k", "v", "out"):
            mods.append((f"te_text_model_encoder_layers_{i}_self_attn_"
                         f"{p}_proj", tcfg.hidden_size, tcfg.hidden_size, 0))
    out = []
    for name, cin, cout, k in mods:
        kk = (k, k) if k else ()
        one = (1, 1) if k else ()
        down = torch.randn((rank, cin) + kk, generator=g) * 0.02
        up = torch.randn((cout, rank) + one, generator=g) * 0.02
        out += [(f"lora_{name}.lora_down.weight", tuple(down.shape),
                 torch.float16, (lambda t=down: t)),
                (f"lora_{name}.lora_up.weight", tuple(up.shape),
                 torch.float16, (lambda t=up: t)),
                (f"lora_{name}.alpha", (), torch.float16,
                 (lambda: torch.tensor(float(rank))))]
    return out


def _edge_image(size: int) -> np.ndarray:
    """A canny-like control image: white edges of circles and lines on
    black."""
    y, x = np.mgrid[:size, :size] / size
    edges = np.zeros((size, size), bool)
    for cx, cy, r in ((0.3, 0.4, 0.2), (0.7, 0.6, 0.15)):
        edges |= np.abs(np.hypot(x - cx, y - cy) - r) < 0.004
    edges |= np.abs(y - 0.85) < 0.003
    return np.repeat(edges[..., None], 3, axis=2).astype(np.uint8) * 255


def phase_serve_sd15(card: str, root: Path) -> dict:
    """SD-1.5's widths and depth (its published configs), seeded bf16
    weights written once and served twice over HTTP: ``sd-1.5-bf16-lora``
    with a rank-8 kohya LoRA at ``lora_scale`` 0.8 (merged at load; the
    merge count asserted), and ``sd-1.5-bf16-controlnet`` with a
    ControlNet of sd-controlnet-canny's config attached and an edge image
    as ``file``: 512x512, 20 steps, ``b64_json``."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.image import controlnet as tcn
    from localai_tpu_torch.image import lora as tlora
    from localai_tpu_torch.image.clip import CLIPTextConfig
    from localai_tpu_torch.image.loader import write_controlnet
    from localai_tpu_torch.image.unet import UNetConfig
    from localai_tpu_torch.models.loader import write_safetensors
    from localai_tpu_torch.models.manager import ModelManager
    from localai_tpu_torch.utils import png

    ckpt = root / "sd-1.5"
    rec = _draw_pipeline(ckpt, {"unet": SD15_UNET_CONFIG,
                                "vae": SD15_VAE_CONFIG,
                                "text": CLIP_L_CONFIG}, seed=81)
    ucfg = UNetConfig.from_hf(SD15_UNET_CONFIG)
    lora = _lora_tensors(ucfg, CLIPTextConfig.from_hf(CLIP_L_CONFIG))
    rec["lora_bytes"] = write_safetensors(root / "sd15-lora.safetensors",
                                          lora)
    rec["lora_layers"] = len(lora) // 3
    t0 = time.monotonic()
    cn_cfg = UNetConfig.from_hf(CANNY_CONFIG)
    cn = tcn.init_params(cn_cfg, 91, "cuda", cond_channels=tuple(
        CANNY_CONFIG["conditioning_embedding_out_channels"]))
    rec["controlnet_params"] = sum(t.numel() for t in _leaves(cn))
    rec["controlnet_gb"] = write_controlnet(root / "canny", cn_cfg, cn,
                                            dtype="bfloat16") / 1e9
    _write_json(root / "canny" / "config.json", CANNY_CONFIG)
    rec["controlnet_write_s"] = time.monotonic() - t0
    del cn
    gc.collect()
    torch.cuda.empty_cache()
    models = root / "models-sd15"
    write_models_dir(models, {
        SD15_LORA: (f"name: {SD15_LORA}\nbackend: diffusers\nmodel: {ckpt}"
                    f"\nlora_adapter: {root / 'sd15-lora.safetensors'}\n"
                    "lora_scale: 0.8\n"),
        SD15_CN: (f"name: {SD15_CN}\nbackend: diffusers\nmodel: {ckpt}\n"
                  f"diffusers:\n  control_net: {root / 'canny'}\n"
                  "  control_scale: 0.9\n")})
    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=str(models), device="cuda",
                                     image_path=str(root / "images")),
                           loader)
    server = APIServer(manager, "127.0.0.1", 0).start()
    merged: list = []
    apply_lora = tlora.apply_lora
    tlora.apply_lora = lambda *a, **k: merged.append(
        apply_lora(*a, **k)) or merged[-1]
    served = {}
    try:
        edge = base64.b64encode(png.encode(_edge_image(SD15_SIZE))).decode()
        for name, extra in ((SD15_LORA, {}), (SD15_CN, {"file": edge})):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            sm = manager.get_image(name)
            torch.cuda.synchronize()
            m = {"load_s": time.monotonic() - t0,
                 "peak_gb_after_load": torch.cuda.max_memory_allocated()
                 / 1e9}
            times: dict = {}
            _timed_pipeline(sm.pipeline, times)
            walls = []
            for i, prompt in enumerate(IMAGE_PROMPTS):
                out, wall = _image_request(server.url, {
                    "model": name, "prompt": prompt,
                    "size": f"{SD15_SIZE}x{SD15_SIZE}", "step": IMAGE_STEPS,
                    "seed": 10 + i, "response_format": "b64_json", **extra})
                walls.append(wall)
                _check_png(base64.b64decode(out["data"][0]["b64_json"]),
                           SD15_SIZE)
            m.update(_times_record(times, walls))
            m["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            served[name] = m
        if merged != [rec["lora_layers"]]:
            raise AssertionError(f"LoRA merges {merged}, not "
                                 f"[{rec['lora_layers']}]")
        if manager.get_image(SD15_CN).pipeline.controlnet_params is None:
            raise AssertionError(f"{SD15_CN}: no ControlNet attached")
        return {**rec, "served": served}
    finally:
        tlora.apply_lora = apply_lora
        server.shutdown()
        manager.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# FLUX (the rectified-flow MMDiT with CLIP and T5 conditioning)

FLUX_DEV = "flux.1-dev-f32"
# black-forest-labs/FLUX.1-dev's transformer/, text_encoder_2/ (T5-v1.1-XXL's
# encoder), vae/ and scheduler/ config.json files, as published; its
# text_encoder/ is CLIP_L_CONFIG
FLUX_DEV_TRANSFORMER_CONFIG = {
    "_class_name": "FluxTransformer2DModel", "attention_head_dim": 128,
    "axes_dims_rope": [16, 56, 56], "guidance_embeds": True,
    "in_channels": 64, "joint_attention_dim": 4096,
    "num_attention_heads": 24, "num_layers": 19, "num_single_layers": 38,
    "patch_size": 1, "pooled_projection_dim": 768}
FLUX_DEV_T5_CONFIG = {
    "architectures": ["T5EncoderModel"], "classifier_dropout": 0.0,
    "d_ff": 10240, "d_kv": 64, "d_model": 4096, "decoder_start_token_id": 0,
    "dense_act_fn": "gelu_new", "dropout_rate": 0.1, "eos_token_id": 1,
    "feed_forward_proj": "gated-gelu", "initializer_factor": 1.0,
    "is_encoder_decoder": True, "is_gated_act": True,
    "layer_norm_epsilon": 1e-06, "model_type": "t5",
    "num_decoder_layers": 24, "num_heads": 64, "num_layers": 24,
    "output_past": True, "pad_token_id": 0,
    "relative_attention_max_distance": 128,
    "relative_attention_num_buckets": 32, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32128}
# the published VAE sets use_quant_conv / use_post_quant_conv false and
# ships no quant convs, which the JAX package's loader (and the port's, a
# limit of the reference it keeps) cannot read: written here with them
FLUX_DEV_VAE_CONFIG = {
    "_class_name": "AutoencoderKL", "act_fn": "silu",
    "block_out_channels": [128, 256, 512, 512],
    "down_block_types": ["DownEncoderBlock2D"] * 4, "force_upcast": True,
    "in_channels": 3, "latent_channels": 16, "latents_mean": None,
    "latents_std": None, "layers_per_block": 2,
    "mid_block_add_attention": True, "norm_num_groups": 32,
    "out_channels": 3, "sample_size": 1024, "scaling_factor": 0.3611,
    "shift_factor": 0.1159, "up_block_types": ["UpDecoderBlock2D"] * 4,
    "use_post_quant_conv": True, "use_quant_conv": True}
FLUX_DEV_SCHEDULER_CONFIG = {
    "_class_name": "FlowMatchEulerDiscreteScheduler",
    "base_image_seq_len": 256, "base_shift": 0.5, "max_image_seq_len": 4096,
    "max_shift": 1.15, "num_train_timesteps": 1000, "shift": 3.0,
    "use_dynamic_shifting": True}
FLUX_SIZE, FLUX_I2I_SIZE, FLUX_STEPS = 1024, 512, 4
FLUX_T5_PIECES, FLUX_T5_EXTRA_IDS = 32000, 100
# bytes of the directory at full depth in bf16, with room to spare
FLUX_DIR_BYTES = 36_000_000_000


def _flux_debug_configs() -> dict:
    """``debug:flux-tiny``'s configs (``image.flux.DEBUG_CONFIGS``) with
    the VAE and CLIP in float32, for the card = CPU checks."""
    from localai_tpu_torch.image.flux import DEBUG_CONFIGS

    return {k: dataclasses.replace(c, dtype="float32")
            for k, c in DEBUG_CONFIGS.items()}


def phase_flux_parity() -> dict:
    """Card = CPU at ``debug:flux-tiny``'s widths in float32 (TF32 off):
    T5's states (with and without a key mask) and the MMDiT's velocity
    within 1e-4 of the largest output; one whole ``generate`` (3 steps,
    the same seeded CPU draw on both devices) and a 0.5-strength img2img:
    latents within 1e-4, pixels within 1."""
    from localai_tpu_torch.image import clip as tclip
    from localai_tpu_torch.image import mmdit as tmm
    from localai_tpu_torch.image import t5 as tt5
    from localai_tpu_torch.image import vae as tvae
    from localai_tpu_torch.image.flux import FluxPipeline
    from localai_tpu_torch.image.loader import map_tree
    from localai_tpu_torch.utils.device import full_f32
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    c = _flux_debug_configs()
    trees = {"mmdit": _perturbed(tmm.init_params(c["mmdit"], 1, "cpu"), 11,
                                 std=0.02),
             "vae": _perturbed(tvae.init_params(c["vae"], 2, "cpu"), 12),
             "clip": _perturbed(tclip.init_params(c["clip"], 3, "cpu"), 13),
             "t5": _perturbed(tt5.init_params(c["t5"], 4, "cpu"), 14)}
    dev = {d: {k: map_tree(v, lambda t, d=d: t.to(d))
               for k, v in trees.items()} for d in ("cuda", "cpu")}
    rng = np.random.default_rng(71)
    ids = torch.from_numpy(rng.integers(0, 258, (2, 24)))
    mask = torch.ones((2, 24), dtype=torch.bool)
    mask[1, 17:] = False
    mc = c["mmdit"]
    img = torch.from_numpy(rng.normal(size=(1, 64, 16)).astype(np.float32))
    txt = torch.from_numpy(rng.normal(size=(1, 9, 32)).astype(np.float32))
    pooled = torch.from_numpy(rng.normal(size=(1, 64)).astype(np.float32))
    img_ids = torch.zeros((64, 3))
    img_ids[:, 1] = torch.arange(64) // 8
    img_ids[:, 2] = torch.arange(64) % 8
    res: dict = {}
    with torch.inference_mode(), full_f32():
        for d in ("cuda", "cpu"):
            p = dev[d]
            mv = lambda t, d=d: t.to(d)  # noqa: E731
            res[d] = {
                "t5": tt5.encode(c["t5"], p["t5"], mv(ids)),
                "t5_masked": tt5.encode(c["t5"], p["t5"], mv(ids),
                                        mv(mask)),
                "velocity": tmm.forward(
                    mc, p["mmdit"], mv(img), mv(txt), mv(pooled),
                    mv(torch.tensor([0.7])), mv(img_ids),
                    mv(torch.zeros((9, 3))),
                    guidance=mv(torch.tensor([3.5])))}
    errs = {k: _rel_err(res["cuda"][k], res["cpu"][k]) for k in res["cpu"]}
    pipes = {d: FluxPipeline(mc, dev[d]["mmdit"], c["vae"], dev[d]["vae"],
                             c["clip"], dev[d]["clip"], ByteTokenizer(),
                             c["t5"], dev[d]["t5"], ByteTokenizer(),
                             device=d) for d in ("cuda", "cpu")}
    init = rng.integers(0, 256, (80, 48, 3), np.uint8)
    for name, kw in (("generate", {}),
                     ("img2img", {"init_image": init, "strength": 0.5})):
        a, b = (pipes[d].generate("a red fox", width=64, height=64,
                                  steps=3, seed=9, **kw)
                for d in ("cuda", "cpu"))
        errs[f"latents-{name}"] = _rel_err(a.latents, b.latents)
        errs[f"pixels-{name}"] = int(np.abs(
            a.image.astype(int) - b.image.astype(int)).max())
    bad = {k: v for k, v in errs.items()
           if v > (1 if k.startswith("pixels") else 1e-4)}
    if bad:
        raise AssertionError(f"FLUX parity: card != CPU: {bad}")
    print("flux parity: " + json.dumps(errs), flush=True)
    return errs


def _flux_drawer(kind_of, seed: int, shapes: dict):
    """``get(path, layer, transposed)`` drawing each entry of the file on
    the card from its own generator (``seed`` + the entry's ordinal, in
    the order the writer asks): ones, zeros, or a gaussian times the
    scale ``kind_of(path, shape)`` gives; ``shapes`` is the tree's
    ``param_shapes``."""
    from localai_tpu_torch.image.loader import entry_shape

    count = [0]

    def get(path, layer, tr):
        s = entry_shape(shapes, path, layer, tr)
        kind = kind_of(path, s)
        count[0] += 1
        if kind == "ones":
            return torch.ones(s, device="cuda")
        if kind == "zeros":
            return torch.zeros(s, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(seed + count[0])
        return torch.randn(s, generator=g, device="cuda").mul_(kind)
    return get


def _write_flux_dev(root: Path, depth: Optional[tuple] = None) -> dict:
    """FLUX.1-dev's directory at its published configs (``depth`` (double,
    single, T5 layers) cuts the depth, never the widths): the MMDiT (the
    JAX package's init: 0.02-std weights, zero biases, unit qk gains) and
    T5-XXL's encoder (fan-in-scaled weights, unit norm gains) drawn on the
    card entry by entry and streamed to disk in bf16, T5 in two shards;
    CLIP-L and the VAE drawn whole; CLIP's and T5's tokenizers from the
    smoke's writers. Returns params, bytes and seconds."""
    from localai_tpu_torch.image import clip as tclip
    from localai_tpu_torch.image import loader as tload
    from localai_tpu_torch.image import mmdit as tmm
    from localai_tpu_torch.image import t5 as tt5
    from localai_tpu_torch.image import vae as tvae
    from localai_tpu_torch.image.clip import CLIPTextConfig
    from localai_tpu_torch.image.vae import VAEConfig

    t0 = time.monotonic()
    thf, t5hf = dict(FLUX_DEV_TRANSFORMER_CONFIG), dict(FLUX_DEV_T5_CONFIG)
    if depth:
        thf.update(num_layers=depth[0], num_single_layers=depth[1])
        t5hf.update(num_layers=depth[2])
    mcfg = tmm.FluxConfig.from_hf(thf)
    t5cfg = tt5.T5Config.from_hf(t5hf)
    mshapes, tshapes = tmm.param_shapes(mcfg), tt5.param_shapes(t5cfg)

    def mmdit_kind(path, s):
        kind = tmm.leaf_kind(path[-1])
        return 0.02 if kind == "normal" else kind

    def t5_kind(path, s):
        if path[-1] in ("ln1", "ln2", "final_ln"):
            return "ones"
        if path[-1] in ("embed", "rel_embed"):
            return 1.0
        return 1.0 / float(np.sqrt(s[-1]))      # [out, in] on disk

    ccfg = CLIPTextConfig.from_hf(CLIP_L_CONFIG)
    vcfg = VAEConfig.from_hf(FLUX_DEV_VAE_CONFIG)
    clip = tclip.init_params(ccfg, 91, "cuda")
    vae = tvae.init_params(vcfg, 92, "cuda")
    n = tload.write_diffusers_pipeline(
        root, vae=(vcfg, vae), text=(ccfg, clip), dtype="bfloat16",
        transformer=(mcfg, _flux_drawer(mmdit_kind, 1000, mshapes)),
        t5=(t5cfg, _flux_drawer(t5_kind, 5000, tshapes)), t5_shards=2,
        configs={"transformer": thf, "text_encoder_2": t5hf,
                 "text_encoder": CLIP_L_CONFIG, "vae": FLUX_DEV_VAE_CONFIG})
    (root / "scheduler").mkdir(exist_ok=True)
    _write_json(root / "scheduler" / "scheduler_config.json",
                FLUX_DEV_SCHEDULER_CONFIG)
    write_clip_tokenizer(root / "tokenizer")
    vocab = write_t5_tokenizer(root / "tokenizer_2", FLUX_T5_PIECES,
                               FLUX_T5_EXTRA_IDS)
    params = {"mmdit": sum(int(np.prod(s)) for s in _leaves(mshapes)),
              "t5": sum(int(np.prod(s)) for s in _leaves(tshapes)),
              "clip": sum(t.numel() for t in _leaves(clip)),
              "vae": sum(t.numel() for t in _leaves(vae))}
    del clip, vae
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"params": params, "params_total": sum(params.values()),
            "t5_vocab": vocab, "checkpoint_gb": n / 1e9,
            "write_s": time.monotonic() - t0}


def _flux_block_check(pipe, tokens_img: int = 1024) -> dict:
    """One full-width double block and one single block of the served
    MMDiT (layer 0 of each) at 512²'s 1152 tokens (1024 image + 128 text)
    on the card against the CPU, float32 with TF32 off: within 1e-4 of
    the largest output; each block's card ms (CUDA events around the
    block alone, its inputs already on the card)."""
    from localai_tpu_torch.image import mmdit as tmm
    from localai_tpu_torch.image.loader import map_tree
    from localai_tpu_torch.utils.device import full_f32

    cfg = pipe.cfg
    g = torch.Generator().manual_seed(81)
    D, T = cfg.dim, pipe.max_t5_len
    side = int(round(tokens_img ** 0.5))
    x = torch.randn((1, tokens_img, D), generator=g)
    c = torch.randn((1, T, D), generator=g)
    temb = torch.nn.functional.silu(torch.randn((1, D), generator=g))
    ids = torch.zeros((T + tokens_img, 3))
    ids[T:, 1] = torch.arange(tokens_img) // side
    ids[T:, 2] = torch.arange(tokens_img) % side
    blocks = {"double": tmm._at(pipe.params["double"], 0),
              "single": tmm._at(pipe.params["single"], 0)}
    out: dict = {}
    with torch.inference_mode(), full_f32():
        for d in ("cuda", "cpu"):
            p = {k: map_tree(v, lambda t, d=d: t.to(d))
                 for k, v in blocks.items()}
            cos, sin = tmm.rope_3d(cfg, ids.to(d))
            # inputs on the device first: the events time the blocks alone
            xi, ci, ti = x.to(d), c.to(d), temb.to(d)
            cxi = torch.cat([ci, xi], 1)
            run_d = lambda: tmm.double_block(  # noqa: E731
                cfg, p["double"], xi, ci, ti, cos, sin)
            run_s = lambda: tmm.single_block(  # noqa: E731
                cfg, p["single"], cxi, ti, cos, sin)
            if d == "cuda":
                run_d(), run_s()
                ms_d, xd = _events_ms(run_d)
                ms_s, xs = _events_ms(run_s)
                out["double_ms"], out["single_ms"] = ms_d, ms_s
            else:
                xd, xs = run_d(), run_s()
            out[d] = (xd[0], xd[1], xs)
            del p
    errs = [_rel_err(a, b) for a, b in zip(out.pop("cuda"), out.pop("cpu"))]
    rec = {"tokens": tokens_img + T, "double_x_rel_err": errs[0],
           "double_c_rel_err": errs[1], "single_rel_err": errs[2],
           **out}
    if max(errs) > 1e-4:
        raise AssertionError(f"FLUX blocks: card != CPU at full width: "
                             f"{rec}")
    return rec


def phase_serve_flux(card: str) -> dict:
    """``flux.1-dev-f32``: FLUX.1-dev's widths and depth (its published
    configs), seeded bf16 weights drawn on the card and streamed to disk
    (~33.7 GB), served from a ``backend: diffusers`` YAML through the HTTP
    server in the JAX package's float32 (the MMDiT and T5; CLIP and the
    VAE in their configs' bf16), TF32 off: one 1024x1024 request of 4
    steps (``b64_json``), then a 512x512 img2img request from that image
    (``file``, strength 0.75: 3 steps). Prints load seconds, peak memory
    after the load and across the requests, T5-encode / MMDiT-step /
    VAE-decode ms (CUDA events around the served calls), seconds an image,
    the full-width double and single block card = CPU check at 1152
    tokens, and K1–K5 launches (0, asserted). The depth is cut only when
    neither scratch location has room for the full directory."""
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.image import t5 as tt5
    from localai_tpu_torch.image.flux import FluxPipeline
    from localai_tpu_torch.models.manager import ModelManager
    from localai_tpu_torch.utils import png

    t5_encode = tt5.encode
    kernels = _all_kernels()
    # a snapshot, not a reset: the image group's counts run across it
    before = {k: w.launches for k, w in kernels.items()}
    depth = None
    try:
        root = Path(_scratch_dir("flux-", FLUX_DIR_BYTES))
    except AssertionError as e:
        # a third of the depth fits in a third of the room
        root = Path(_scratch_dir("flux-", FLUX_DIR_BYTES // 3))
        depth = (7, 13, 8)
        print(f"flux: full depth does not fit ({e}); depth cut to "
              f"{depth}", flush=True)
    try:
        rec = {"card": card, "depth_cut": depth,
               **_write_flux_dev(root / "flux.1-dev", depth)}
        print("flux write: " + json.dumps(rec), flush=True)
        models = root / "models"
        write_models_dir(models, {FLUX_DEV: (
            f"name: {FLUX_DEV}\nbackend: diffusers\n"
            f"model: {root / 'flux.1-dev'}\n")})
        loader = ConfigLoader(models)
        loader.load_from_path()
        manager = ModelManager(AppConfig(model_path=str(models),
                                         device="cuda",
                                         image_path=str(root / "images")),
                               loader)
        server = APIServer(manager, "127.0.0.1", 0).start()
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            sm = manager.get_image(FLUX_DEV)
            torch.cuda.synchronize()
            rec["load_s"] = time.monotonic() - t0
            rec["allocated_gb_after_load"] = \
                torch.cuda.memory_allocated() / 1e9
            rec["peak_gb_after_load"] = \
                torch.cuda.max_memory_allocated() / 1e9
            pipe = sm.pipeline
            if not isinstance(pipe, FluxPipeline):
                raise AssertionError(f"{FLUX_DEV}: loaded a "
                                     f"{type(pipe).__name__}")
            if {t.dtype for t in _leaves(pipe.params)} != {torch.float32}:
                raise AssertionError("the MMDiT is not float32")
            times: dict = {}
            for name in ("_encode", "_velocity", "_decode", "_encode_img",
                         "generate"):
                setattr(pipe, name, _timed(getattr(pipe, name),
                                           times.setdefault(name, [])))
            # T5 alone inside the text encode (the pipeline calls the
            # module's function)
            tt5.encode = _timed(t5_encode, times.setdefault("t5", []))
            requests = []
            body = {"model": FLUX_DEV, "prompt": IMAGE_PROMPTS[0],
                    "size": f"{FLUX_SIZE}x{FLUX_SIZE}", "step": FLUX_STEPS,
                    "seed": 3, "response_format": "b64_json"}
            out, wall = _image_request(server.url, body)
            first = base64.b64decode(out["data"][0]["b64_json"])
            _check_png(first, FLUX_SIZE)
            requests.append({"size": FLUX_SIZE, "wall_s": wall,
                             "steps": len(times["_velocity"])})
            steps_before = len(times["_velocity"])
            small = png.encode(png.decode(first)[::2, ::2].copy())
            out, wall = _image_request(server.url, {
                **body, "prompt": IMAGE_PROMPTS[1], "seed": 4,
                "size": f"{FLUX_I2I_SIZE}x{FLUX_I2I_SIZE}",
                "file": base64.b64encode(small).decode()})
            _check_png(base64.b64decode(out["data"][0]["b64_json"]),
                       FLUX_I2I_SIZE)
            requests.append({"size": FLUX_I2I_SIZE, "img2img": True,
                             "wall_s": wall, "steps":
                             len(times["_velocity"]) - steps_before})
            lat = [r.latents for _, r in times["generate"]]
            if not all(bool(torch.isfinite(x).all()) for x in lat):
                raise AssertionError("FLUX latents are not finite")
            step_ms = [ms for ms, _ in times["_velocity"]]
            rec.update(
                requests=requests,
                t5_encode_ms=[ms for ms, _ in times["t5"]],
                text_encode_ms=[ms for ms, _ in times["_encode"]],
                mmdit_ms_per_step_1024=step_ms[:steps_before],
                mmdit_ms_per_step_512=step_ms[steps_before:],
                vae_decode_ms=[ms for ms, _ in times["_decode"]],
                vae_encode_ms=[ms for ms, _ in times["_encode_img"]],
                s_per_image=[r["wall_s"] for r in requests],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            if requests[0]["steps"] != FLUX_STEPS or \
                    requests[1]["steps"] != int(FLUX_STEPS * 0.75):
                raise AssertionError(f"FLUX steps: {requests}")
            rec["blocks"] = _flux_block_check(pipe)
            if depth:
                # the full-depth float32 peak, from the measured bytes of
                # each loaded block
                def per_layer(tree, n):
                    return sum(t.nbytes for t in tree.values()) / n
                missing = (
                    (19 - depth[0]) * per_layer(pipe.params["double"],
                                                depth[0])
                    + (38 - depth[1]) * per_layer(pipe.params["single"],
                                                  depth[1])
                    + (24 - depth[2]) * per_layer(pipe.t5_params["layers"],
                                                  depth[2]))
                rec["full_depth_peak_gb_reckoned"] = \
                    rec["peak_gb"] + missing / 1e9
        finally:
            tt5.encode = t5_encode
            server.shutdown()
            manager.shutdown()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _no_launches(FLUX_DEV, kernels, before)
    rec["k1_k5_launches"] = 0
    print("flux: " + json.dumps(rec), flush=True)
    return rec


def phase_image(card: str) -> dict:
    """The image group: card = CPU at debug widths, then the SDXL and
    SD-1.5 serves, then FLUX's card = CPU check and its FLUX.1-dev serve
    (a scratch directory of its own); K1–K5 launch never (every count
    zeroed first). Its command time is printed."""
    kernels = _all_kernels()
    for w in kernels.values():
        w.launches = 0
    t0 = time.monotonic()
    root = Path(_scratch_dir("image-", 12_000_000_000))
    phase_s, rec = {}, {"card": card}
    try:
        for name, run in (("parity", phase_image_parity),
                          ("sdxl", lambda: phase_serve_sdxl(card, root)),
                          ("sd15", lambda: phase_serve_sd15(card, root))):
            t1 = time.monotonic()
            rec[name] = run()
            phase_s[name] = time.monotonic() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _no_launches("the image group's UNet paths", kernels)
    for name, run in (("flux_parity", phase_flux_parity),
                      ("flux", lambda: phase_serve_flux(card))):
        t1 = time.monotonic()
        rec[name] = run()
        phase_s[name] = time.monotonic() - t1
    _no_launches("the image group", kernels)
    rec.update(phase_s=phase_s, k1_k5_launches=0,
               group_s=time.monotonic() - t0)
    print("image: " + json.dumps(rec), flush=True)
    return rec


# -- the tuning table's sweep, the gallery and the vector store ----------

AUTOTUNE_DTYPES = ("bfloat16", "int8", "int4")
AUTOTUNE_BLOCKS = (16, 32, 64, 128)
AUTOTUNE_CTX = 512
GALLERY = "smoke"
GALLERY_MODEL = "llama3-8b-gallery"
GALLERY_BLOCK = 32        # the table's block size for the gallery serve
GALLERY_CHAT = {"messages": [{"role": "user", "content":
                              "Name three rivers of Europe."}],
                "max_tokens": 32, "temperature": 0}
STORE_KEYS = 262144       # bge-large-en-v1.5's width: 1 GiB of f32 keys
STORE_HTTP_KEYS = 1024
STORE_DIM = 1024
STORE_FINDS = 64
STORE_TOPK = 10


def phase_autotune(card: str) -> dict:
    """``tools.autotune``'s sweep at its ``llama3-8b`` preset (head dim
    128, 8 kv heads, group 4, 4 slots, a 512-row context) over bf16, int8
    and int4 pools at blocks 16/32/64/128: K1 ("pallas", at one buffer
    depth: it moves nothing on K1) and its plain version ("xla"), each
    point's 10 calls captured once in a CUDA graph and its replays timed
    on CUDA events, best of 3; the fastest K1 point of each key
    installed, or the default block's where the two are within the
    spread of their runs. Every kernel point's output is then held
    against its plain version on the same inputs (bf16: per slot,
    relative; float32 q over a scaled pool: absolute — the K1 cases'
    tolerances). Prints the points, the table and each key's sweep
    seconds; K2–K5 launch 0 in the sweep."""
    import tempfile

    from localai_tpu_torch.obs.metrics import REGISTRY
    from localai_tpu_torch.ops import tuning
    from localai_tpu_torch.ops.attention import paged_decode_attention_ref
    from localai_tpu_torch.tools import autotune

    hd, kv = autotune.PRESET_SHAPES["llama3-8b"]
    kernels = _all_kernels()
    for w in kernels.values():
        w.launches = 0
    path = os.path.join(tempfile.mkdtemp(prefix="autotune-"), "tuning.json")
    table = tuning.TuningTable(path=path)
    t0 = time.monotonic()
    records = autotune.sweep(
        [(hd, kv)], list(AUTOTUNE_DTYPES), [1],
        block_candidates=list(AUTOTUNE_BLOCKS), buffer_candidates=[2],
        impls=[autotune.PLAIN_IMPL, autotune.KERNEL_IMPL],
        ctx=AUTOTUNE_CTX, interpret=False, table=table, device="cuda")
    sweep_s = time.monotonic() - t0
    launches = {k: w.launches for k, w in kernels.items()}
    failed = [r for r in records if "error" in r]
    if failed:
        raise AssertionError(f"autotune: failed points {failed}")
    # a point's wrapper calls: 2 warm-ups and the 10 captured calls (the
    # graph's replays launch K1 without calling it)
    want = len(AUTOTUNE_DTYPES) * len(AUTOTUNE_BLOCKS) * (2 + 10)
    if launches != {**{k: 0 for k in kernels},
                    "paged_decode_attention": want}:
        raise AssertionError(f"autotune: launches {launches}, expected "
                             f"{want} of K1 and none of another kernel")
    checks = []
    for dt in AUTOTUNE_DTYPES:
        for bt in AUTOTUNE_BLOCKS:
            inp = autotune.point_inputs(hd, kv, dt, block_tokens=bt,
                                        ctx=AUTOTUNE_CTX, device="cuda")
            out = autotune.point_fn(inp, autotune.KERNEL_IMPL)()
            torch.cuda.synchronize()
            q = inp["q"]
            ref_kv = ((inp["k"], inp["v"]) if inp["k_scale"] is not None
                      else (inp["k"].float(), inp["v"].float()))
            ref = paged_decode_attention_ref(
                q.float(), *ref_kv, inp["tables"], inp["positions"],
                inp["k_scale"], inp["v_scale"])
            err, ok = _check_rows(f"autotune-{dt}-bt{bt}", out, ref,
                                  q.dtype)
            checks.append({"kv_dtype": dt, "block_tokens": bt,
                           "max_abs_err": err})
            if not ok:
                raise AssertionError(f"autotune: K1 at {dt} bt {bt} "
                                     "disagrees with its plain version")
    table.save()
    tuning.reset()
    back = tuning.TuningTable.load(path)
    if back.entries != table.entries or len(back.entries) != len(
            AUTOTUNE_DTYPES):
        raise AssertionError(f"autotune: table {back.entries}")
    for key, e in back.entries.items():
        if e.impl != autotune.KERNEL_IMPL:
            raise AssertionError(f"autotune: {key} installed {e}")
    seconds = {dict(k)["key"]: v for k, v in
               REGISTRY.autotune_sweep_seconds._series.items()}
    out = {"card": card, "preset": "llama3-8b", "head_dim": hd,
           "kv_heads": kv, "group": 4, "slots": 4, "ctx": AUTOTUNE_CTX,
           "points": [r for r in records if "us" in r],
           "table": {k: e.to_dict() for k, e in back.entries.items()},
           "sweep_seconds": seconds, "sweep_s": sweep_s,
           "k1_launches": launches["paged_decode_attention"],
           "checks": checks}
    print("autotune: " + json.dumps(out), flush=True)
    return out


def _quiet_files_server(root):
    """A stdlib HTTP server of the files under ``root`` on a free
    localhost port, serving on a thread of its own."""
    import http.server

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(root), **k)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _metric(url: str, name: str, labels: str) -> float:
    """A sample of ``/metrics`` (0 when the series is absent)."""
    for line in _get(url + "/metrics")[1].decode().splitlines():
        if line.startswith(f"{name}{{{labels}}} "):
            return float(line.split()[-1])
    return 0.0


def _get_json(url: str):
    return json.loads(_get(url)[1])


def phase_gallery_serve(card: str, ckpt: Path) -> dict:
    """A gallery install that ends in a chat on the card. A stdlib HTTP
    server (in this process) serves a gallery index that defines an entry
    with an anchor and derives the installed one with ``!!merge <<:``, a
    definition YAML, and the files of the Llama-3-8B checkpoint that
    ``phase_serve_checkpoint`` wrote (published widths, the depth of
    ``SMOKE_LAYERS``), each with its sha256. Through the port's server
    (``cli.main.build_server``): ``POST /models/galleries``, ``GET
    /models/available`` (the entry listed, not installed), ``POST
    /models/apply``, ``/models/jobs/{uuid}`` polled until processed with a
    progress between 0 and 100 % seen on the way. With
    ``LOCALAI_TUNE_CACHE`` at a table whose ``hd128_kv8_bfloat16_tp1``
    entry sets ``block_tokens`` 32, the installed model loads (one lookup:
    ``localai_autotune_lookups_total{result="hit"}`` rises by exactly 1 in
    ``/metrics``, the runner's block size is 32) and streams a greedy
    chat: K1 launches L per decode step, K2–K5 none; its token ids equal
    those of the same checkpoint served by path with
    ``LOCALAI_KV_BLOCK_TOKENS=32``. ``POST /models/delete/{name}`` then
    takes the name out of ``/v1/models`` and the files off the disk. K1
    at bt 32 is held against its plain version and timed."""
    import concurrent.futures
    import shutil

    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.ops import tuning
    from localai_tpu_torch.utils.downloader import sha256_file

    root = ckpt.parent
    httpd = None
    files = sorted(p for p in ckpt.iterdir() if p.is_file())
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(files)) as ex:
        shas = dict(zip(files, ex.map(sha256_file, files)))
    sha_s = time.monotonic() - t0
    total = sum(p.stat().st_size for p in files)
    httpd = _quiet_files_server(root)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    gal = root / "gallery"
    gal.mkdir(exist_ok=True)
    (gal / "index.yaml").write_text(
        "- &llama3\n"
        "  name: llama3-8b-gallery-base\n"
        "  description: \"Meta-Llama-3-8B-Instruct's widths, seeded "
        "weights\"\n"
        "  license: llama3\n"
        f"  url: {base}/gallery/llama3.yaml\n"
        "  tags:\n  - llm\n  - chat\n"
        f"- !!merge <<: *llama3\n  name: {GALLERY_MODEL}\n")
    lines = ["config_file:", f"  model: {ckpt.name}", "files:"]
    for p in files:
        lines += [f"  - filename: {ckpt.name}/{p.name}",
                  f"    uri: {base}/{ckpt.name}/{p.name}",
                  f"    sha256: {shas[p]}"]
    (gal / "llama3.yaml").write_text("\n".join(lines) + "\n")
    models = root / "gallery-models"
    models.mkdir()
    bypath = "llama3-8b-bf16-bypath"
    (models / f"{bypath}.yaml").write_text(f"model: {ckpt}\n")
    table = root / "tuning.json"
    hf = json.loads((ckpt / "config.json").read_text())
    hd = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    key = tuning.shape_key(hd, hf["num_key_value_heads"], "bfloat16", 1)
    tuning.TuningTable({key: tuning.TuneEntry(impl="pallas",
                                              block_tokens=GALLERY_BLOCK)},
                       path=str(table)).save()
    saved_env = {k: os.environ.get(k) for k in (
        "LOCALAI_MODELS_PATH", "LOCALAI_ADDRESS", "LOCALAI_PORT",
        "LOCALAI_CONFIG_PATH", "LOCALAI_TUNE_CACHE", "LOCALAI_API_KEYS",
        "LOCALAI_KV_BLOCK_TOKENS")}
    server = sm = None
    kernels = _all_kernels()
    try:
        os.environ.update({
            "LOCALAI_MODELS_PATH": str(models),
            "LOCALAI_ADDRESS": "127.0.0.1", "LOCALAI_PORT": "0",
            "LOCALAI_CONFIG_PATH": str(root / "gallery-configuration"),
            "LOCALAI_TUNE_CACHE": str(table)})
        for k in ("LOCALAI_API_KEYS", "LOCALAI_KV_BLOCK_TOKENS"):
            os.environ.pop(k, None)
        tuning.reset()
        server = build_server(["run"]).start()
        url = server.url
        added = json.loads(_post(url + "/models/galleries", {
            "name": GALLERY, "url": f"{base}/gallery/index.yaml"}).read())
        listed = {m["name"]: m for m in _get_json(url + "/models/available")}
        entry = listed.get(GALLERY_MODEL)
        if (added["name"] != GALLERY or entry is None
                or entry["gallery"] != GALLERY or entry["installed"]
                or entry["license"] != "llama3"
                or entry["tags"] != ["llm", "chat"]):
            raise AssertionError(f"gallery: /models/available lists "
                                 f"{entry}")
        t0 = time.monotonic()
        job = json.loads(_post(url + "/models/apply", {
            "id": f"{GALLERY}@{GALLERY_MODEL}"}).read())
        partial, polls = [], 0
        while True:
            st = _get_json(url + job["status"])
            polls += 1
            if st["processed"]:
                break
            if 0.0 < st["progress"] < 100.0:
                partial.append(st["progress"])
            if time.monotonic() - t0 > 300:
                raise AssertionError(f"gallery: install stuck at {st}")
            time.sleep(0.05)
        install_s = time.monotonic() - t0
        if st["error"] or st["progress"] != 100.0 or not partial:
            raise AssertionError(f"gallery: install ended {st}, partial "
                                 f"progress seen {partial[:3]}")
        names = {m["id"] for m in _get_json(url + "/v1/models")["data"]}
        listed = {m["name"]: m for m in _get_json(url + "/models/available")}
        if GALLERY_MODEL not in names or \
                not listed[GALLERY_MODEL]["installed"]:
            raise AssertionError(f"gallery: {GALLERY_MODEL} not served "
                                 f"after its install ({sorted(names)})")
        installed = models / ckpt.name
        for p in files:
            if (installed / p.name).stat().st_size != p.stat().st_size:
                raise AssertionError(f"gallery: {p.name} not installed")
        hit = 'result="hit"'
        hits0 = _metric(url, "localai_autotune_lookups_total", hit)
        t0 = time.monotonic()
        sm = server.manager.get(GALLERY_MODEL)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        hits = _metric(url, "localai_autotune_lookups_total", hit) - hits0
        if hits != 1 or sm.runner.block_tokens != GALLERY_BLOCK:
            raise AssertionError(f"gallery: {hits} tuning-table hits, "
                                 f"block_tokens {sm.runner.block_tokens}")

        def greedy(name: str, model, stream: bool) -> dict:
            handles: list = []

            def recorded(req, _submit=model.scheduler.submit):
                h = _submit(req)
                handles.append(h)
                return h

            model.scheduler.submit = recorded
            for w in kernels.values():
                w.launches = 0
            steps0 = model.runner.decode_steps
            body = dict(GALLERY_CHAT, model=name, stream=stream)
            t = time.monotonic()
            ttft, text = None, ""
            if stream:
                with _post(url + "/v1/chat/completions", body) as r:
                    for line in r:
                        if not line.startswith(b"data: {"):
                            continue
                        d = json.loads(line[6:])["choices"][0]["delta"]
                        if d.get("content"):
                            ttft = ttft or time.monotonic() - t
                            text += d["content"]
            else:
                text = json.loads(_post(url + "/v1/chat/completions",
                                        body).read())["choices"][0][
                    "message"]["content"]
            wall = time.monotonic() - t
            launches = {k: w.launches for k, w in kernels.items()}
            steps = model.runner.decode_steps - steps0
            L = model.runner.cfg.num_layers
            want = {**{k: 0 for k in kernels},
                    "paged_decode_attention": L * steps}
            if steps <= 0 or launches != want or len(handles) != 1:
                raise AssertionError(f"gallery: {name} launches {launches}"
                                     f", expected {want}")
            return {"ids": list(handles[0].token_ids), "text": text,
                    "wall_s": wall, "ttft_s": ttft, "decode_steps": steps,
                    "launches": launches,
                    "verify_windows": model.runner.verify_windows}

        served = greedy(GALLERY_MODEL, sm, stream=True)
        server.manager.shutdown_model(GALLERY_MODEL, force=True)
        sm = None
        gc.collect()
        torch.cuda.empty_cache()
        os.environ["LOCALAI_KV_BLOCK_TOKENS"] = str(GALLERY_BLOCK)
        ref_model = server.manager.get(bypath)
        if ref_model.runner.block_tokens != GALLERY_BLOCK:
            raise AssertionError("gallery: the by-path model is not at "
                                 f"bt {GALLERY_BLOCK}")
        ref = greedy(bypath, ref_model, stream=False)
        server.manager.shutdown_model(bypath, force=True)
        ref_model = None
        if served["ids"] != ref["ids"]:
            raise AssertionError(f"gallery: installed ids {served['ids']} "
                                 f"!= by-path ids {ref['ids']}")
        t0 = time.monotonic()
        job = json.loads(_post(url + f"/models/delete/{GALLERY_MODEL}",
                               {}).read())
        while not (st := _get_json(url + job["status"]))["processed"]:
            if time.monotonic() - t0 > 120:
                raise AssertionError(f"gallery: delete stuck at {st}")
            time.sleep(0.05)
        delete_s = time.monotonic() - t0
        names = {m["id"] for m in _get_json(url + "/v1/models")["data"]}
        if st["error"] or GALLERY_MODEL in names or installed.exists() \
                or (models / f"{GALLERY_MODEL}.yaml").exists():
            raise AssertionError(f"gallery: delete left {st} {names}")
        case = kernel_case("gallery-bt32", torch.bfloat16,
                           bt=GALLERY_BLOCK, MB=4096 // GALLERY_BLOCK,
                           timed=True, seed=12)
        out = {"card": card, "model": GALLERY_MODEL, "files": len(files),
               "bytes": total, "sha256_s": sha_s, "install_s": install_s,
               "install_gb_per_s": total / install_s / 1e9,
               "progress_seen": [partial[0], partial[-1], len(partial)],
               "polls": polls, "load_s": load_s, "tuning_hits": hits,
               "tuning_key": key, "block_tokens": GALLERY_BLOCK,
               "delete_s": delete_s,
               "served": {k: v for k, v in served.items() if k != "ids"},
               "ids_equal_by_path": True, "tokens": len(served["ids"])}
        print("gallery serve: " + json.dumps(out), flush=True)
        return {"launches": served["launches"], "k1_bt32": case,
                "figures": out}
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tuning.reset()
        if server is not None:
            server.shutdown()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        server = sm = None
        shutil.rmtree(models, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_stores(card: str) -> dict:
    """The vector store on the card at bge-large-en-v1.5's embedding
    width: 262144 keys of width 1024 through ``VectorStore.set`` in
    batches and 1024 more through ``POST /stores/set``, then 64 ``POST
    /stores/find`` at ``topk`` 10, each held against a float64 numpy
    cosine top-k on the host (lower row first on equal scores): the same
    rows in the same order, similarities within 1e-5. One query points
    along five stored keys that are power-of-two multiples of one vector
    (equal scores to the last bit): they must come back lower row first.
    Prints the set and rebuild times, find p50/p99 and the store's bytes
    on the card; K1–K5 launch 0."""
    import tempfile

    from localai_tpu_torch.cli.main import build_server

    kernels = _all_kernels()
    for w in kernels.values():
        w.launches = 0
    rng = np.random.default_rng(23)
    n = STORE_KEYS + STORE_HTTP_KEYS
    keys = rng.standard_normal((n, STORE_DIM), dtype=np.float32)
    tie = rng.standard_normal(STORE_DIM, dtype=np.float32)
    tie_rows = tuple(int(STORE_KEYS * f) for f in (0.004, 0.19, 0.5, 0.76)
                     ) + (STORE_KEYS + 7,)
    for j, row in enumerate(tie_rows):
        keys[row] = tie * np.float32(2.0 ** (j - 2))
    models = tempfile.mkdtemp(prefix="stores-models-")
    srv = build_server(["run", "--models-path", models, "--address",
                        "127.0.0.1", "--port", "0"]).start()
    try:
        store = srv.manager.stores.get("default")
        t0 = time.monotonic()
        batch = 16384
        for i in range(0, STORE_KEYS, batch):
            j = min(i + batch, STORE_KEYS)
            store.set(keys[i:j], [str(r).encode() for r in range(i, j)])
        set_s = time.monotonic() - t0
        t0 = time.monotonic()
        _post(srv.url + "/stores/set", {
            "keys": keys[STORE_KEYS:].tolist(),
            "values": [str(r) for r in range(STORE_KEYS, n)]}).read()
        http_set_s = time.monotonic() - t0
        if len(store) != n:
            raise AssertionError(f"stores: {len(store)} keys, not {n}")
        find = srv.url + "/stores/find"
        t0 = time.monotonic()
        _post(find, {"key": rng.standard_normal(STORE_DIM).tolist(),
                     "topk": STORE_TOPK}).read()
        first_s = time.monotonic() - t0
        rebuild_s = store.last_rebuild_s
        nbytes = store.device_bytes()
        # queries: noisy copies of stored keys, fresh random ones, and
        # the tied direction
        queries = []
        for i in range(STORE_FINDS - 1):
            if i % 2:
                q = rng.standard_normal(STORE_DIM)
            else:
                q = keys[rng.integers(n)] + 0.3 * rng.standard_normal(
                    STORE_DIM)
            queries.append(q.astype(np.float32))
        queries.insert(STORE_FINDS // 2, tie)
        walls, answers = [], []
        for q in queries:
            t = time.monotonic()
            answers.append(json.loads(_post(find, {
                "key": q.tolist(), "topk": STORE_TOPK}).read()))
            walls.append(time.monotonic() - t)
        # the float64 reference on the host
        mat = keys.astype(np.float64)
        norms = np.linalg.norm(mat, axis=1)
        qs = np.stack(queries).astype(np.float64)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        sims = (mat @ qs.T) / norms[:, None]
        gaps = []
        rows = np.arange(n)
        for j, ans in enumerate(answers):
            col = sims[:, j]
            # score first, then the lower row (scores equal to 1e-12 tie)
            order = np.lexsort((rows, -np.round(col, 12)))[:STORE_TOPK + 1]
            want = [str(r) for r in order[:STORE_TOPK]]
            if j != STORE_FINDS // 2:     # not the tied query
                gaps.append(float(np.min(-np.diff(col[order]))))
            if ans["values"] != want:
                raise AssertionError(f"stores: find {j} gave rows "
                                     f"{ans['values']}, float64 {want}")
            err = np.max(np.abs(np.asarray(ans["similarities"])
                                - col[order[:STORE_TOPK]]))
            if err > 1e-5:
                raise AssertionError(f"stores: find {j} similarities off "
                                     f"by {err}")
            got = np.asarray(ans["keys"], np.float32)
            if not np.array_equal(got, keys[order[:STORE_TOPK]]):
                raise AssertionError(f"stores: find {j} keys differ")
        tie_ans = answers[STORE_FINDS // 2]["values"][:len(tie_rows)]
        if tie_ans != [str(r) for r in sorted(tie_rows)]:
            raise AssertionError(f"stores: tied keys came back {tie_ans}")
        _no_launches("phase_stores", kernels)
        ms = sorted(w * 1e3 for w in walls)
        out = {"card": card, "keys": n, "dim": STORE_DIM,
               "capacity_rows": nbytes // (STORE_DIM * 4 + 5),
               "device_bytes": nbytes, "set_s": set_s,
               "http_set_1024_s": http_set_s, "first_find_s": first_s,
               "rebuild_s": rebuild_s, "finds": len(walls),
               "find_ms_p50": ms[len(ms) // 2],
               "find_ms_p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
               "min_f64_gap_top11": min(gaps),
               "tie_rows": list(tie_rows)}
        print("stores: " + json.dumps(out), flush=True)
        return out
    finally:
        srv.manager.stores.drop("default")
        srv.shutdown()
        srv = None
        shutil.rmtree(models, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# -- the KV economy and the in-process fleet (ROADMAP item 23 part 1) -----

KV_TIER = "llama3-8b-bf16-kv-tier"
KV_TIER_MB = 1024
KV_TIER_NEW = 32            # max_tokens of each chat
KV_TIER_PROMPT = 1056       # prompt tokens a chat: 16 full 64-token blocks
KV_TIER_BT = 64
FLEET = "llama3-8b-bf16-fleet"
FLEET_THRESHOLD = 512       # --fleet-disagg-threshold
FLEET_STREAM = 128          # tokens of the migrated stream
# a byte-level model writes ASCII only under this bias (ids 128–255 of
# the byte tokenizer are the non-ASCII bytes): a live migration drops a
# multi-byte character the donor's detokenizer holds at the boundary, on
# both packages, so the drill compares texts that have none
ASCII_ONLY = {str(i): -100 for i in range(128, 256)}
_WORDS = ("paged", "block", "prefix", "tier", "host", "spill", "reload",
          "chain", "hash", "pool", "card", "fleet", "replica", "router",
          "decode", "prefill", "token", "cache", "stream", "batch")


def _prose(seed: int, nbytes: int) -> str:
    """``nbytes`` of seeded ASCII words."""
    rng = np.random.default_rng(seed)
    out = ""
    while len(out) < nbytes:
        out += _WORDS[int(rng.integers(len(_WORDS)))] + " "
    return out[:nbytes]


def _env(updates: dict) -> dict:
    """Set (value) or unset (None) environment variables; returns the
    previous values for ``_env`` to restore."""
    saved = {k: os.environ.get(k) for k in updates}
    for k, v in updates.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return saved


def _sse_chat(url: str, body: dict, headers: Optional[dict] = None,
              on_delta=None) -> dict:
    """One streamed chat: {"text", "ttft_s", "wall_s", "prompt_tokens",
    "completion_tokens", "finish"}; ``on_delta(n)`` runs after the n-th
    content delta."""
    req = urllib.request.Request(
        url, data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t = time.monotonic()
    ttft, text, last, n = None, "", None, 0
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: {"):
                continue
            frame = json.loads(line[6:])
            if frame.get("choices"):
                delta = frame["choices"][0]["delta"].get("content")
                if delta:
                    if ttft is None:
                        ttft = time.monotonic() - t
                    text += delta
                    n += 1
                    if on_delta is not None:
                        on_delta(n)
            last = frame
    usage = (last or {}).get("usage", {})
    return {"text": text, "ttft_s": ttft, "wall_s": time.monotonic() - t,
            "prompt_tokens": usage.get("prompt_tokens", 0),
            "completion_tokens": usage.get("completion_tokens", 0),
            "finish": ((last or {}).get("choices") or [{}])[0].get(
                "finish_reason")}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def _pool_round_trip(cfg) -> dict:
    """``pack_block`` / ``load_block`` on the card at ``cfg``'s pool shape
    (bt 64) for bf16, float32, int8 and int4 pools: the block's bytes come
    back bit for bit and no other block moves. {kv_dtype: payload bytes}."""
    from localai_tpu_torch.engine import kvcache as kvc
    from localai_tpu_torch.engine.runner import ModelRunner

    out = {}
    for kv_dtype in ("bfloat16", "float32", "int8", "int4"):
        holder = type("PoolHolder", (), {})()
        holder.paged, holder.device = True, torch.device("cuda")
        holder.kv = kvc.init_paged_cache(cfg, 4, KV_TIER_BT, kv_dtype,
                                         device="cuda")
        pool = ModelRunner._pool_tensors(holder)
        g = torch.Generator(device="cuda").manual_seed(5)
        for t in pool.values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
            else:
                t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                                      device="cuda", dtype=torch.int8))
        before = {n: t.clone() for n, t in pool.items()}
        holder._pool_tensors = lambda h=holder: ModelRunner._pool_tensors(h)
        payload = ModelRunner.pack_block(holder, 2).wait()
        for n, t in pool.items():
            if not payload[n].is_pinned() or not torch.equal(
                    payload[n].view(torch.uint8),
                    before[n][:, 2].cpu().view(torch.uint8)):
                raise AssertionError(f"kv tier: {kv_dtype} {n} spill "
                                     "payload is not the block's bytes")
            t[:, 2].zero_()
        ModelRunner.load_block(holder, 2, payload)
        torch.cuda.synchronize()
        for n, t in pool.items():
            if not torch.equal(t.view(torch.uint8),
                               before[n].view(torch.uint8)):
                raise AssertionError(f"kv tier: {kv_dtype} {n} reload is "
                                     "not bit for bit")
        out[kv_dtype] = sum(a.nbytes for a in payload.values())
        del holder, pool, before, payload
    torch.cuda.empty_cache()
    return out


def _copy_times(runner) -> dict:
    """Device ms of one block's spill (``pack_block``: the gather and the
    copy into pinned memory) and reload (``load_block``), best of 5, on
    CUDA events, with GB/s; the same spill done as one copy per layer,
    and the host ms the engine thread spends issuing each."""
    bid = 1
    nbytes = sum(t[:, bid].numel() * t.element_size()
                 for t in runner._pool_tensors().values())
    spill, reload, per_layer, host_spill, host_reload = [], [], [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        ms, payload = _events_ms(lambda: runner.pack_block(bid))
        host_spill.append((time.perf_counter() - t0) * 1e3)
        spill.append(ms)
        t0 = time.perf_counter()
        ms, _ = _events_ms(lambda: runner.load_block(bid, payload))
        host_reload.append((time.perf_counter() - t0) * 1e3)
        reload.append(ms)
        host = {n: torch.empty(t[:, bid].shape, dtype=t.dtype,
                               pin_memory=True)
                for n, t in runner._pool_tensors().items()}

        def layers():
            for n, t in runner._pool_tensors().items():
                for lay in range(t.shape[0]):
                    host[n][lay].copy_(t[lay, bid], non_blocking=True)

        per_layer.append(_events_ms(layers)[0])
    best = {"spill": min(spill), "reload": min(reload),
            "spill_per_layer": min(per_layer)}
    return {"block_bytes": nbytes,
            **{f"{k}_ms": v for k, v in best.items()},
            **{f"{k}_gb_s": nbytes / (v * 1e-3) / 1e9
               for k, v in best.items()},
            "host_spill_ms": min(host_spill),
            "host_reload_ms": min(host_reload)}


def phase_kv_tier(card: str) -> dict:
    """The host KV tier on the main path: ``debug:llama3-8b`` (Llama-3-8B's
    widths and all 32 layers, seeded bf16 weights drawn on the card),
    bf16 paged at bt 64, through ``cli.main.build_server`` over HTTP. The
    pool holds the trash block, two 1024-token prefixes (16 blocks each,
    8 MiB a block) and one live chat's blocks past its prefix, so a third
    prefix evicts the oldest. Four streamed chats over system prompts A,
    B, C, then A again, each of ``KV_TIER_PROMPT`` prompt tokens, first
    with ``LOCALAI_KV_TIER_MB`` unset (no tier), then with it at 1024:
    the second A reloads at least 15 of its 16 blocks from host memory,
    the greedy texts equal the tier-off serve's, ``spills_total`` and
    ``reloads_total`` are above 0, ``check_invariants()`` is empty, and
    K1 launches L a plain decode step in both serves (K2–K5 never).
    Before the serves, the pool round trip (``pack_block`` /
    ``load_block``) is checked byte for byte on the card for bf16,
    float32, int8 and int4 pools at this shape. Prints ms and GB/s of a
    spill and a reload (and the spill as one copy per layer), the TTFT of
    the second A against the first (cold), and the peak memory."""
    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.models.registry import DEBUG_PRESETS
    from localai_tpu_torch.templates.cache import TemplateCache
    from localai_tpu_torch.templates.chat import build_chat_prompt

    cfg = dataclasses.replace(DEBUG_PRESETS["llama3-8b"], dtype="bfloat16")
    L = cfg.num_layers
    payload_bytes = _pool_round_trip(cfg)
    print("kv tier round trip: " + json.dumps(payload_bytes), flush=True)
    root = Path(_scratch_dir("kv-tier-", 1 << 20))
    models = root / "models"
    models.mkdir()
    doc = {"name": KV_TIER, "model": "debug:llama3-8b", "context_size": 2048,
           "seed": 11, "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                                  "max_slots": 2,
                                  "kv_block_tokens": KV_TIER_BT}}
    mcfg = ModelConfig.from_dict(doc)
    mcfg.set_defaults()
    templates = TemplateCache(str(models))

    def messages(tag: int) -> list:
        user = {"role": "user", "content": "Summarize the notes."}
        probe = build_chat_prompt(templates, mcfg, [
            {"role": "system", "content": "x"}, user])
        # the byte tokenizer: a token a byte, and the BOS id
        n = KV_TIER_PROMPT - 1 - (len(probe.encode()) - 1)
        return [{"role": "system", "content": _prose(tag, n)}, user]

    chats = [messages(t) for t in (1, 2, 3, 1)]
    # blocks of one live chat: its prompt, the answer and the n-gram
    # drafter's lookahead; its 16 full prompt blocks join the prefix pool
    live = -(-(KV_TIER_PROMPT + KV_TIER_NEW + 8) // KV_TIER_BT)
    doc["engine"]["kv_num_blocks"] = 1 + 2 * 16 + (live - 16)
    (models / f"{KV_TIER}.yaml").write_text(json.dumps(doc))
    kernels = _all_kernels()
    runs = {}
    try:
        for tier in (None, KV_TIER_MB):
            saved = _env({"LOCALAI_MODELS_PATH": models,
                          "LOCALAI_ADDRESS": "127.0.0.1",
                          "LOCALAI_PORT": "0", "LOCALAI_KV_TIER_MB": tier})
            server = None
            try:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                server = build_server(["run"]).start()
                sm = server.manager.get(KV_TIER)
                torch.cuda.synchronize()
                url = server.url + "/v1/chat/completions"
                body = {"model": KV_TIER, "max_tokens": KV_TIER_NEW,
                        "temperature": 0}
                run = _counted(sm, kernels, lambda: [
                    _sse_chat(url, {**body, "messages": m}) for m in chats])
                res = run.pop("result")
                _check_k1(f"{KV_TIER} tier={tier}", run, L)
                alloc = sm.runner.allocator
                problems = alloc.check_invariants()
                if problems:
                    raise AssertionError(f"{KV_TIER}: {problems[:3]}")
                bad = [r["prompt_tokens"] for r in res
                       if not 16 * KV_TIER_BT < r["prompt_tokens"]
                       <= 17 * KV_TIER_BT]
                if bad:
                    raise AssertionError(f"{KV_TIER}: prompt tokens {bad}, "
                                         "not 16 full blocks and a tail")
                rec = {"tier_mb": tier, "texts": [r["text"] for r in res],
                       "ttft_s": [r["ttft_s"] for r in res],
                       "evictions": alloc.evictions_total,
                       "tier": alloc.tier_stats(),
                       "metrics": {k: v for k, v in
                                   sm.scheduler.metrics().items()
                                   if k.startswith("kv_tier_")},
                       "launches": run,
                       "max_memory_allocated_gb":
                           torch.cuda.max_memory_allocated() / 1e9,
                       "memory_before_gb": base / 1e9}
                if tier:
                    rec["copy"] = _copy_times(sm.runner)
                runs[tier] = rec
                print(f"kv tier serve ({card}): " + json.dumps(
                    {k: v for k, v in rec.items() if k != "texts"}),
                    flush=True)
            finally:
                if server is not None:
                    server.shutdown()
                _env(saved)
                sm = server = alloc = None
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    on, off = runs[KV_TIER_MB], runs[None]
    if on["texts"] != off["texts"]:
        raise AssertionError("kv tier: greedy texts differ from the serve "
                             "with the tier off")
    ts = on["tier"]
    if ts is None or ts["spills_total"] <= 0 or ts["reloads_total"] < 15:
        raise AssertionError(f"kv tier: the second A did not reload from "
                             f"host memory ({ts})")
    if off["tier"] is not None:
        raise AssertionError("kv tier: a tier without LOCALAI_KV_TIER_MB")
    if on["max_memory_allocated_gb"] > 75.0:
        raise AssertionError("kv tier: peak memory over 75 GB")
    out = {"card": card, "spills": ts["spills_total"],
           "reloads": ts["reloads_total"],
           "ttft_first_a_s": on["ttft_s"][0],
           "ttft_second_a_s": on["ttft_s"][3],
           "ttft_second_a_off_s": off["ttft_s"][3], **on["copy"],
           "payload_bytes": payload_bytes,
           "peak_gb": on["max_memory_allocated_gb"],
           "launches": on["launches"], "launches_off": off["launches"]}
    print("kv tier: " + json.dumps(out), flush=True)
    return out


class _FleetSteps:
    """Decode steps of every replica engine a fleet ran since this was
    made: engines started later count from 0, a retired or restarted
    engine up to the last ``note()`` before it went."""

    def __init__(self, fm):
        import weakref

        self._ref = weakref.ref
        self.fm = fm
        self.entries: list = []      # [weak runner, start, last]
        self.note(first=True)

    def note(self, first: bool = False) -> None:
        for r in self.fm.pool.members():
            sm = r.sm
            if sm is None:
                continue
            run = sm.runner
            for e in self.entries:
                if e[0]() is run:
                    e[2] = run.decode_steps
                    break
            else:
                self.entries.append([self._ref(run),
                                     run.decode_steps if first else 0,
                                     run.decode_steps])

    def total(self) -> int:
        self.note()
        return sum(last - start for _, start, last in self.entries)


def _fleet_check_k1(what: str, kernels: dict, steps: int, L: int) -> None:
    want = L * steps
    got = kernels["paged_decode_attention"].launches
    if steps <= 0 or got != want:
        raise AssertionError(f"{what}: K1 launches {got}, expected {want} "
                             f"({L} x {steps} decode steps over the "
                             "replicas)")
    _no_launches(what, {k: w for k, w in kernels.items()
                        if k != "paged_decode_attention"})


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=600) as r:
        return json.loads(r.read())


def phase_fleet(card: str) -> dict:
    """In-process fleets of ``debug:llama3-8b`` at Llama-3-8B's widths and
    ``SMOKE_LAYERS["fleet"]`` layers (a bf16 checkpoint of seeded weights
    drawn on the card, with no tokenizer file: the byte tokenizer), bf16
    paged, through ``cli.main.build_server`` over HTTP. A single engine
    serves the reference texts first. Then ``--fleet-backend inprocess
    --fleet-replicas 2 --fleet-prefill-replicas 1
    --fleet-disagg-threshold 512``:
      (a) four chats sharing a 256-token system prompt land on one decode
          replica (``/v1/fleet`` routed reasons), texts = the reference;
      (b) an 1100-token prompt prefills on ``p0``, its KV chunks go to the
          decode replica, which resumes without prefilling those rows;
      (c) ``migrate_inflight`` moves a live 128-token stream to the other
          decode replica; its text equals the stream without migration;
      (d) ``kill()`` of the decode replica a prompt routes to: the request
          fails over (reason ``failover``), its text is equal, the replica
          respawns healthy and the card holds no more memory than before;
      (f) ``/debug/fleet/flight`` merges the replicas' rings and
          ``/v1/traces/{id}`` stitches the replicas that served (b);
    then a second server with ``--fleet-replicas 2`` and the autoscaler
    on, its thresholds lowered by ``LOCALAI_AUTOSCALE_*``:
      (e) a burst scales out to 3 decode replicas, idleness drains one
          back in (``FleetScheduler.drain``), every request answered, and
          the retired replica's weights and pool leave the card.
    K1 launches L per decode step summed over every replica engine of each
    server (K2–K5 never); peak memory stays under 75 GB."""
    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.loader import write_llama_checkpoint
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    L = SMOKE_LAYERS["fleet"]
    cfg = dataclasses.replace(DEBUG_PRESETS["llama3-8b"], dtype="bfloat16",
                              num_layers=L)
    root = Path(_scratch_dir("fleet-", 7_000_000_000))
    models, ckpt = root / "models", root / "llama3-8b-fleet"
    kernels = _all_kernels()
    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()

    def released(what: str) -> float:
        """The card's allocated bytes once ``what`` was shut down: every
        engine of it freed (fails on anything left of it)."""
        gc.collect()
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - base
        print(f"fleet: {left / 1e9:.3f} GB still allocated after {what}",
              flush=True)
        if left > 0.25e9:
            raise AssertionError(f"fleet: {left / 1e9:.2f} GB left on the "
                                 f"card after {what}")
        return left / 1e9

    try:
        t0 = time.monotonic()
        params = tl.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(11), "cuda")
        write_llama_checkpoint(ckpt, cfg, params, dtype="bfloat16")
        (ckpt / "config.json").write_text(json.dumps(
            {**LLAMA3_8B_CONFIG, "num_hidden_layers": L}))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"fleet checkpoint: {L} layers written in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        models.mkdir()
        (models / f"{FLEET}.yaml").write_text(json.dumps(
            {"name": FLEET, "model": str(ckpt), "context_size": 4096,
             "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                        "max_slots": 8, "kv_block_tokens": 64}}))
        system = _prose(21, 256)
        questions = ["Write a haiku about paged attention.",
                     "What is the capital of France?",
                     "List three prime numbers.",
                     "Explain continuous batching in one sentence."]
        affinity = [{"model": FLEET, "max_tokens": 32, "temperature": 0,
                     "messages": [{"role": "system", "content": system},
                                  {"role": "user", "content": q}]}
                    for q in questions]
        long_body = {"model": FLEET, "max_tokens": 32, "temperature": 0,
                     "messages": [{"role": "user",
                                   "content": _prose(22, 1100)}]}
        stream_body = {"model": FLEET, "max_tokens": FLEET_STREAM,
                       "temperature": 0, "ignore_eos": True,
                       "logit_bias": ASCII_ONLY,
                       "messages": [{"role": "user", "content":
                                     "Stream across the fleet " * 4}]}
        failover_body = {"model": FLEET, "max_tokens": 32, "temperature": 0,
                         "messages": [{"role": "user", "content":
                                       _prose(23, 300)}]}
        base_env = {"LOCALAI_MODELS_PATH": models,
                    "LOCALAI_ADDRESS": "127.0.0.1", "LOCALAI_PORT": "0"}
        # the reference: one engine of the same checkpoint
        saved = _env(base_env)
        server = None
        try:
            server = build_server(["run"]).start()
            url = server.url + "/v1/chat/completions"
            sm = server.manager.get(FLEET)
            run = _counted(sm, kernels, lambda: {
                "affinity": [json.loads(_post(url, b).read())
                             for b in affinity],
                "long": json.loads(_post(url, long_body).read()),
                "stream": _sse_chat(url, stream_body),
                "failover": json.loads(_post(url, failover_body).read())})
            ref = run.pop("result")
            _check_k1(f"{FLEET} single engine", run, L)
        finally:
            if server is not None:
                server.shutdown()
            _env(saved)
            sm = server = None
            gc.collect()
            torch.cuda.empty_cache()
        out = {"card": card, "layers": L,
               "left_after_single_gb": released("the single engine")}

        def text(resp):
            return resp["choices"][0]["message"]["content"]

        saved = _env(base_env)
        try:
            server = build_server([
                "run", "--fleet-backend", "inprocess", "--fleet-replicas",
                "2", "--fleet-prefill-replicas", "1",
                "--fleet-disagg-threshold", str(FLEET_THRESHOLD)]).start()
            url = server.url + "/v1/chat/completions"
            t0 = time.monotonic()
            fm = server.manager.get(FLEET)
            out["boot_s"] = time.monotonic() - t0
            one_bytes = _tree_bytes(fm.pool.members()[0].sm.runner.params) \
                + _tree_bytes(fm.pool.members()[0].sm.runner._pool_tensors())
            handles: list = []

            def recorded(req, _submit=fm.scheduler.submit):
                h = _submit(req)
                handles.append(h)
                return h

            fm.scheduler.submit = recorded
            for w in kernels.values():
                w.launches = 0
            steps = _FleetSteps(fm)
            # (a) affinity
            got = []
            for i, b in enumerate(affinity):
                hdr = {"X-Trace-ID": f"fleet-a-{i}"}
                req = urllib.request.Request(
                    url, data=json.dumps(b).encode(),
                    headers={"Content-Type": "application/json", **hdr})
                with urllib.request.urlopen(req, timeout=600) as r:
                    got.append(text(json.loads(r.read())))
            status = _get_json(server.url + "/v1/fleet")["models"][FLEET]
            served = {r["id"]: r["dispatched"] for r in status["replicas"]
                      if r["role"] == "decode" and r["dispatched"]}
            routed = status["router"]["routed"]
            if (got != [text(r) for r in ref["affinity"]]
                    or len(served) != 1
                    or routed["affinity"] + routed["directory"] < 4):
                raise AssertionError(f"fleet (a): served {served}, routed "
                                     f"{routed}, texts equal "
                                     f"{got == [text(r) for r in ref['affinity']]}")
            out["a"] = {"served": served, "routed": dict(routed)}
            # (b) disaggregation
            before = dict(transfers=fm.scheduler.prefix_transfers,
                          nbytes=fm.scheduler.prefix_transfer_bytes)
            decs = {r.id: r.sm.scheduler.metrics()["prompt_cache"]
                    for r in fm.pool.members() if r.role == "decode"}
            chunks0 = {r.id: r.sm.runner.prefill_chunks
                       for r in fm.pool.members()}
            req = urllib.request.Request(
                url, data=json.dumps(long_body).encode(),
                headers={"Content-Type": "application/json",
                         "X-Trace-ID": "fleet-b"})
            with urllib.request.urlopen(req, timeout=600) as r:
                long_resp = json.loads(r.read())
            hits = {r.id: r.sm.scheduler.metrics()["prompt_cache"]
                    for r in fm.pool.members() if r.role == "decode"}
            dest = [rid for rid in hits
                    if hits[rid]["hits"] > decs[rid]["hits"]]
            chunks = {r.id: r.sm.runner.prefill_chunks - chunks0[r.id]
                      for r in fm.pool.members()}
            moved = fm.scheduler.prefix_transfer_bytes - before["nbytes"]
            if (fm.scheduler.prefix_transfers != before["transfers"] + 1
                    or len(dest) != 1
                    or hits[dest[0]]["hit_tokens"]
                    - decs[dest[0]]["hit_tokens"] < 1024
                    or chunks[dest[0]] > 1
                    or text(long_resp) != text(ref["long"])):
                raise AssertionError(f"fleet (b): transfers "
                                     f"{fm.scheduler.prefix_transfers}, "
                                     f"dest {dest}, chunks {chunks}")
            out["b"] = {"prompt_tokens": long_resp["usage"]["prompt_tokens"],
                        "chunk_bytes": moved, "decode_replica": dest[0],
                        "prefill_chunks": chunks}
            # (c) live migration of a streamed request
            res: dict = {}
            mig_thread: list = []

            def migrate(n):
                if n == 4 and not mig_thread:
                    h = handles[-1]
                    res["donor"] = fm.scheduler._active[h.id][1].id
                    th = threading.Thread(target=lambda: res.setdefault(
                        "ok", fm.scheduler.migrate_inflight(h, timeout=60)))
                    th.start()
                    mig_thread.append(th)

            mig0 = fm.scheduler.migrations
            streamed = _sse_chat(url, stream_body, on_delta=migrate)
            mig_thread[0].join(120)
            if (res.get("ok") is not True
                    or fm.scheduler.migrations != mig0 + 1
                    or streamed["text"] != ref["stream"]["text"]
                    or streamed["completion_tokens"] != FLEET_STREAM):
                raise AssertionError(f"fleet (c): migrated {res}, tokens "
                                     f"{streamed['completion_tokens']}, "
                                     "text equal "
                                     f"{streamed['text'] == ref['stream']['text']}")
            out["c"] = {"donor": res["donor"],
                        "tokens": streamed["completion_tokens"]}
            # (d) failover and respawn: the replica the request routes to
            # is killed as the request is submitted (the probe's route
            # counts once in the router's reasons)
            steps.note()
            before_mem = torch.cuda.memory_allocated()
            victim = {}

            def kill_routed(req, _submit=recorded):
                if not victim:
                    t, _ = fm.router.route(req.prompt)
                    t.kill()
                    steps.note()
                    victim["id"] = t.id
                    victim["r"] = t
                    start = t.start

                    def measured_start():
                        # the pool's respawn: stop() ran, start() comes
                        torch.cuda.synchronize()
                        victim["after_stop"] = torch.cuda.memory_allocated()
                        del t.start
                        return start()

                    t.start = measured_start
                return _submit(req)

            fm.scheduler.submit = kill_routed
            fail0 = fm.scheduler.failovers
            fresp = json.loads(_post(url, failover_body).read())
            fm.scheduler.submit = recorded
            rep = victim["r"]
            t0 = time.monotonic()
            while rep.state != "healthy" and time.monotonic() - t0 < 300:
                time.sleep(0.1)
            respawn_s = time.monotonic() - t0
            torch.cuda.synchronize()
            gc.collect()
            after_mem = torch.cuda.memory_allocated()
            routed = _get_json(server.url + "/v1/fleet")["models"][FLEET][
                "router"]["routed"]
            freed = before_mem - victim.get("after_stop", before_mem)
            if (text(fresp) != text(ref["failover"])
                    or fm.scheduler.failovers != fail0 + 1
                    or routed["failover"] < 1 or rep.state != "healthy"
                    or freed < 0.9 * one_bytes
                    or after_mem > before_mem + 0.1 * one_bytes):
                raise AssertionError(f"fleet (d): state {rep.state}, "
                                     f"failovers {fm.scheduler.failovers}, "
                                     f"memory {before_mem} → "
                                     f"{victim.get('after_stop')} (stopped) "
                                     f"→ {after_mem}, a replica "
                                     f"{one_bytes}")
            out["d"] = {"killed": victim["id"], "respawn_s": respawn_s,
                        "memory_before_gb": before_mem / 1e9,
                        "freed_at_stop_gb": freed / 1e9,
                        "memory_after_gb": after_mem / 1e9}
            # (f) the flight view and a stitched trace
            flight = _get_json(server.url + "/debug/fleet/flight")[
                "models"][FLEET]
            trace = _get_json(server.url + "/v1/traces/fleet-b")
            tagged = {e["replica"] for e in trace["waterfall"]
                      if e["replica"]}
            rings = {r["replica"] for r in flight["records"]}
            if (not any(t.endswith("/p0") for t in tagged)
                    or dest[0] not in tagged or len(rings) < 2):
                raise AssertionError(f"fleet (f): waterfall replicas "
                                     f"{tagged}, flight rings {rings}")
            out["f"] = {"waterfall_replicas": sorted(tagged),
                        "flight_records": flight["count"]}
            total = steps.total()
            _fleet_check_k1(f"{FLEET} (a)–(d)", kernels, total, L)
            out["launches"] = kernels["paged_decode_attention"].launches
            out["decode_steps"] = total
            out["routed"] = dict(routed)
        finally:
            server.shutdown()
            _env(saved)
            server = fm = steps = rep = victim = handles = None
            gc.collect()
            torch.cuda.empty_cache()
        out["left_after_fleet_gb"] = released("the first fleet")
        out["e"] = _fleet_autoscale(card, base_env, kernels, L)
        out["left_after_autoscale_gb"] = released("the autoscaled fleet")
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if out["peak_gb"] > 75.0:
            raise AssertionError(f"fleet: peak memory {out['peak_gb']:.1f} "
                                 "GB over 75 GB")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    print("fleet: " + json.dumps(out), flush=True)
    return out


def _fleet_autoscale(card: str, base_env: dict, kernels: dict,
                     L: int) -> dict:
    """(e): the autoscaler over a 2-replica fleet, its thresholds lowered
    by the ``LOCALAI_AUTOSCALE_*`` variables: a burst of 48 chats scales
    out to 3 decode replicas, then idleness drains one back in."""
    from localai_tpu_torch.cli.main import build_server

    env = {**base_env, "LOCALAI_AUTOSCALE": "1",
           "LOCALAI_AUTOSCALE_MIN": "2", "LOCALAI_AUTOSCALE_MAX": "3",
           "LOCALAI_AUTOSCALE_INTERVAL_S": "0.25",
           "LOCALAI_AUTOSCALE_IN_IDLE_S": "3",
           "LOCALAI_AUTOSCALE_OUT_QUEUE": "1",
           "LOCALAI_AUTOSCALE_OUT_COOLDOWN_S": "0",
           "LOCALAI_AUTOSCALE_IN_COOLDOWN_S": "1"}
    saved = _env(env)
    server = None
    try:
        server = build_server(["run", "--fleet-backend", "inprocess",
                               "--fleet-replicas", "2"]).start()
        url = server.url + "/v1/chat/completions"
        fm = server.manager.get(FLEET)
        pool = fm.pool
        one_bytes = _tree_bytes(pool.members()[0].sm.runner.params) \
            + _tree_bytes(pool.members()[0].sm.runner._pool_tensors())
        for w in kernels.values():
            w.launches = 0
        steps = _FleetSteps(fm)
        drains: list = []
        freed: list = []
        remove, drain = pool.remove, fm.scheduler.drain

        def noted_remove(rid, **kw):
            steps.note()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            ok = remove(rid, **kw)
            gc.collect()
            torch.cuda.synchronize()
            freed.append(before - torch.cuda.memory_allocated())
            return ok

        def noted_drain(rid, timeout=30.0):
            r = drain(rid, timeout=timeout)
            drains.append({rid: r})
            return r

        pool.remove, fm.scheduler.drain = noted_remove, noted_drain
        results, errors, peak = [], [], [0]

        def one(i):
            try:
                b = {"model": FLEET, "max_tokens": 64, "temperature": 0,
                     "messages": [{"role": "user",
                                   "content": f"burst request {i}"}]}
                results.append(json.loads(_post(url, b).read()))
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(48)]
        for t in threads:
            t.start()
        seen: dict = {}
        while True:
            n = len(pool.healthy("decode"))
            peak[0] = max(peak[0], n)
            if n >= 3:
                seen.setdefault("out_s", time.monotonic() - t0)
            elif "out_s" in seen:
                seen.setdefault("in_s", time.monotonic() - t0)
            steps.note()
            if not any(t.is_alive() for t in threads):
                seen.setdefault("burst_s", time.monotonic() - t0)
                if peak[0] >= 3 or time.monotonic() - t0 > 90:
                    break
            time.sleep(0.1)
        for t in threads:
            t.join()
        if errors or len(results) != 48 or any(
                r["usage"]["completion_tokens"] <= 0 for r in results):
            raise AssertionError(f"fleet (e): {len(errors)} of 48 burst "
                                 "requests failed")
        while len(pool.healthy("decode")) > 2 \
                and time.monotonic() - t0 < 240:
            steps.note()
            time.sleep(0.1)
        seen.setdefault("in_s", time.monotonic() - t0)
        auto = fm.autoscaler.snapshot()
        if (peak[0] < 3 or len(pool.healthy("decode")) != 2
                or auto["decisions"]["scale_out"] < 1
                or auto["decisions"]["scale_in"] < 1
                or any(v["failed"] for d in drains for v in d.values())
                or not freed or min(freed) < 0.8 * one_bytes):
            raise AssertionError(f"fleet (e): peak {peak[0]} replicas, now "
                                 f"{len(pool.healthy('decode'))}, "
                                 f"decisions {auto['decisions']}, drains "
                                 f"{drains}, freed {freed}")
        total = steps.total()
        _fleet_check_k1(f"{FLEET} (e)", kernels, total, L)
        # seconds from the burst's start: its last answer, 3 replicas
        # healthy, back to 2
        return {**seen, "peak_replicas": peak[0],
                "decisions": auto["decisions"], "drains": drains,
                "freed_gb": [f / 1e9 for f in freed],
                "replica_gb": one_bytes / 1e9,
                "launches": kernels["paged_decode_attention"].launches,
                "decode_steps": total}
    finally:
        if server is not None:
            server.shutdown()
        _env(saved)
        gc.collect()
        torch.cuda.empty_cache()


HTTP_MODEL = "llama3-8b-bf16-http"
HTTP_NEW = 32                # the model's max_tokens: the chat page sends none
HTTP_TOKEN = "smoke-peer-token"
HTTP_TTFT_PAIRS = 24         # direct/router TTFT pairs of a 2-token chat
HTTP_PROXY_PAIRS = 100       # direct/router pairs of GET /v1/models
# the web UI's pages, each GET with and without Accept: text/html
HTTP_PAGES = ("/", "/browse", "/chat/", f"/chat/{HTTP_MODEL}",
              "/text2image/", "/tts/", "/talk/", f"/talk/{HTTP_MODEL}",
              "/swarm", "/slo", "/fleet", "/usage", "/batches", "/swagger")
_URL_HOST = re.compile(r"(?:https?:)?//([\w.\-\[\]:]+?)(?::\d+)?[/\"'\s]")


def _http_get(url: str, accept: Optional[str] = None) -> tuple:
    """(status, content type, body) of a GET."""
    req = urllib.request.Request(
        url, headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _check_pages(base: str) -> dict:
    """Every page and the OpenAPI document, GET with and without
    ``Accept: text/html``: 200, HTML (JSON for ``/`` asked without it and
    for doc.json), and no host named but loopback."""
    kinds = {}
    for path in HTTP_PAGES + ("/swagger/doc.json",):
        for accept in ("text/html", None):
            status, ctype, body = _http_get(base + path, accept)
            want = ("application/json" if path == "/swagger/doc.json"
                    or (path == "/" and accept is None) else "text/html")
            hosts = set(_URL_HOST.findall(body.decode("utf-8", "replace")))
            if (status != 200 or not ctype.startswith(want)
                    or hosts - {"127.0.0.1", "localhost", "::1", "[::1]"}):
                raise AssertionError(f"http surfaces: GET {path} (Accept "
                                     f"{accept}): {status} {ctype}, hosts "
                                     f"{sorted(hosts)}")
            kinds[f"{path} {accept or '*/*'}"] = want
    spec = json.loads(_http_get(base + "/swagger/doc.json")[2])
    if "/v1/chat/completions" not in spec["paths"] or "/swarm/nodes" not in \
            spec["paths"]:
        raise AssertionError("http surfaces: doc.json misses a route")
    return {"gets": len(kinds), "spec_paths": len(spec["paths"])}


def _check_assistants(base: str) -> dict:
    """Create, list, modify and delete an assistant, and upload, attach,
    list, get and detach a file of it."""
    def call(path, body=None, method=None, ctype="application/json"):
        return _request(base + path, body=body, method=method, ctype=ctype)

    st, a = call("/v1/assistants", {"model": HTTP_MODEL, "name": "smoke",
                                    "tools": [{"type": "retrieval"}]})
    aid = a["id"] if st == 200 else None
    ctype, form = _upload_form({"purpose": "assistants"},
                               {"file": ("notes.txt", b"the smoke's notes")})
    steps = [(st, a)]
    steps.append(call("/v1/assistants"))
    steps.append(call(f"/v1/assistants/{aid}",
                      {"model": HTTP_MODEL, "name": "renamed"}))
    st, f = call("/v1/files", form, ctype=ctype)
    steps.append((st, f))
    fid = f["id"] if st == 200 else None
    steps.append(call(f"/v1/assistants/{aid}/files", {"file_id": fid}))
    steps.append(call(f"/v1/assistants/{aid}/files"))
    steps.append(call(f"/v1/assistants/{aid}/files/{fid}"))
    steps.append(call(f"/v1/assistants/{aid}/files/{fid}", method="DELETE"))
    steps.append(call(f"/v1/assistants/{aid}", method="DELETE"))
    steps.append(call(f"/v1/assistants/{aid}"))
    codes = [s for s, _ in steps]
    if (codes != [200] * 9 + [404] or steps[1][1][0]["id"] != aid
            or steps[2][1]["name"] != "renamed"
            or steps[5][1]["data"][0]["id"] != fid
            or not steps[8][1]["deleted"]):
        raise AssertionError(f"http surfaces: assistants answered {codes}")
    return {"calls": len(steps), "codes": codes}


def _router_cost(base: str, rbase: str, chat: dict) -> dict:
    """The router's added latency, measured in pairs taken in turns (the
    order inside a pair alternating) on the server ``base`` directly and
    through the router ``rbase``: the TTFT of one streamed ``chat`` over
    ``HTTP_TTFT_PAIRS`` pairs, and the wall of ``GET /v1/models`` (no
    engine work, so the proxy's own cost stands out of less noise) over
    ``HTTP_PROXY_PAIRS`` pairs. Each is the median of the pairs'
    differences, beside the spread (10th to 90th percentile) of the
    differences and of the direct samples."""

    def chat_ttft(b):
        t = _sse_chat(b + "/v1/chat/completions", chat)["ttft_s"]
        if t is None:
            raise AssertionError("http surfaces (d): a chat streamed no "
                                 "content")
        return t

    def models_wall(b):
        t = time.monotonic()
        code = _http_get(b + "/v1/models")[0]
        if code != 200:
            raise AssertionError(f"http surfaces (d): /v1/models {code}")
        return time.monotonic() - t

    def q(xs, f):
        return float(np.quantile(xs, f))

    out = {}
    for name, fn, n in (("ttft", chat_ttft, HTTP_TTFT_PAIRS),
                        ("models_get", models_wall, HTTP_PROXY_PAIRS)):
        direct, routed = [], []
        for i in range(n):
            if i % 2 == 0:
                direct.append(fn(base))
                routed.append(fn(rbase))
            else:
                routed.append(fn(rbase))
                direct.append(fn(base))
        diffs = [1e3 * (r - d) for d, r in zip(direct, routed)]
        direct = [1e3 * t for t in direct]
        out[name] = {"pairs": n,
                     "direct_ms": [q(direct, f) for f in (0.1, 0.5, 0.9)],
                     "router_ms_median": q([1e3 * t for t in routed], 0.5),
                     "router_added_ms_median": q(diffs, 0.5),
                     "router_added_ms_p10_p90": [q(diffs, 0.1),
                                                 q(diffs, 0.9)]}
    return out


def phase_http_surfaces(card: str) -> dict:
    """The web UI, Swagger, assistants and the federation router on the
    main path: ``debug:llama3-8b`` (Llama-3-8B's widths and all 32 layers,
    seeded bf16 weights drawn on the card), bf16 paged at bt 64, through
    ``cli.main.build_server`` over HTTP. The lm_head columns of printable
    bytes are scaled by 4 after the draw, so the byte tokenizer's greedy
    text is printable (the chat page's body carries no logit bias):
      (a) every web UI page, ``/swagger`` and ``/swagger/doc.json`` answer
          200 with their content type, with and without ``Accept:
          text/html``, and name no host but loopback;
      (b) the chat page's own streamed body (model, messages, stream)
          gives the greedy text of the same chat unstreamed, its trace
          carries ``first_sse_write``, and K1 launches L a decode step;
      (c) an assistant and an assistant file are created, listed,
          modified, read and deleted;
      (d) the port's ``FederatedServer`` on loopback over the server and a
          second ``Listener`` on the same engine: both register with the
          peer token (a wrong one is a 401), the streamed chat through the
          router gives the same text and the node stats show it, then the
          second node stops, the router fails over to the first (the
          stopped node marked offline by that request alone: the router's
          own sweeps are held off) and two health sweeps keep it offline;
          K1 launches L a decode step over (d); the router's added
          latency on a 2-token chat's TTFT and on ``GET /v1/models``,
          direct and routed in turns (``_router_cost``);
    then everything stops and the card holds what it held before."""
    from localai_tpu_torch.api.server import Listener
    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.federation import FederatedServer
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    L = DEBUG_PRESETS["llama3-8b"].num_layers
    t_phase = time.monotonic()
    root = Path(_scratch_dir("http-", 1 << 20))
    models = root / "models"
    models.mkdir()
    (models / f"{HTTP_MODEL}.yaml").write_text(json.dumps({
        "name": HTTP_MODEL, "model": "debug:llama3-8b",
        "context_size": 2048, "seed": 13,
        "parameters": {"max_tokens": HTTP_NEW, "temperature": 0},
        "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                   "max_slots": 4, "kv_block_tokens": 64}}))
    kernels = _all_kernels()
    gc.collect()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    saved = _env({"LOCALAI_MODELS_PATH": models,
                  "LOCALAI_ADDRESS": "127.0.0.1", "LOCALAI_PORT": "0",
                  "LOCALAI_CONFIG_PATH": root / "conf",
                  "LOCALAI_UPLOAD_PATH": root / "uploads"})
    server = second = router = sm = None
    out = {"card": card, "layers": L}
    try:
        server = build_server(["run"]).start()
        t0 = time.monotonic()
        sm = server.manager.get(HTTP_MODEL)
        with torch.no_grad():
            sm.runner.params["lm_head"][:, 32:127] *= 4
        torch.cuda.synchronize()
        out["load_s"] = time.monotonic() - t0
        out["pages"] = _check_pages(server.url)
        page = _http_get(server.url + f"/chat/{HTTP_MODEL}")[2].decode()
        if ("fetch('/v1/chat/completions'" not in page
                or "messages: HISTORY, stream: true" not in page):
            raise AssertionError("http surfaces: the chat page sends "
                                 "another request than the phase's")
        # (b) the chat page's request, as its script builds it
        chat = {"model": HTTP_MODEL, "stream": True, "messages": [
            {"role": "user", "content": "Say hello to the web UI."}]}
        url = server.url + "/v1/chat/completions"
        plain = json.loads(_post(url, {**chat, "stream": False}).read())
        want = plain["choices"][0]["message"]["content"]
        ui = _counted(sm, kernels, lambda: _sse_chat(
            url, chat, headers={"X-Trace-ID": "http-ui-chat"}))
        got = ui.pop("result")
        _check_k1(f"{HTTP_MODEL} chat page", ui, L)
        trace = json.loads(_http_get(
            server.url + "/v1/traces/http-ui-chat")[2])
        marks = [c["name"] for t in trace["traces"]
                 if t["kind"] == "request" for c in t["children"]]
        if (got["text"] != want or not want.strip()
                or got["completion_tokens"] != HTTP_NEW
                or marks.count("first_sse_write") != 1):
            raise AssertionError(f"http surfaces (b): text {got['text']!r} "
                                 f"vs {want!r}, tokens "
                                 f"{got['completion_tokens']}, spans "
                                 f"{marks}")
        out["ui"] = {"text": want, "ttft_s": got["ttft_s"],
                     "launches": ui}
        # (c) assistants
        out["assistants"] = _check_assistants(server.url)
        # (d) the federation router over two front doors of one engine
        second = Listener(server.manager, "127.0.0.1", 0).start()
        # no health sweep of its own during the drill: the failover is the
        # request's, the eviction the sweeps called after it
        router = FederatedServer([], peer_token=HTTP_TOKEN,
                                 health_interval=3600).start()
        reg = router.url + "/federated/register"
        wrong = _request(reg, key="not-the-token",
                         body={"address": f"127.0.0.1:{server.port}"})[0]
        regs = [_request(reg, key=HTTP_TOKEN,
                         body={"address": f"127.0.0.1:{p}"})[0]
                for p in (server.port, second.port)]
        if wrong != 401 or regs != [200, 200] or len(router.nodes()) != 2:
            raise AssertionError(f"http surfaces (d): register {regs}, "
                                 f"wrong token {wrong}")
        rurl = router.url + "/v1/chat/completions"
        node_b = next(n for n in router.nodes()
                      if n.id == f"127.0.0.1:{second.port}")

        def through_router():
            first = _sse_chat(rurl, chat)
            served = {n.id: n.requests_served for n in router.nodes()}
            second.close()
            node_b.requests_served = -1          # chosen first: it is down
            again = _sse_chat(rurl, chat)
            return first, served, again

        fed = _counted(sm, kernels, through_router)
        first, served, again = fed.pop("result")
        _check_k1(f"{HTTP_MODEL} federation", fed, L)
        failed_over = (node_b.online, node_b.failures)
        router.check_health()
        router.check_health()
        listed = json.loads(_http_get(router.url + "/federated/nodes")[2])
        states = {n["id"]: n["online"] for n in listed["nodes"]}
        if (first["text"] != want or again["text"] != want
                or sum(served.values()) != 1 or failed_over != (False, 1)
                or states != {f"127.0.0.1:{server.port}": True,
                              node_b.id: False}
                or node_b.failures != 3):
            raise AssertionError(f"http surfaces (d): texts "
                                 f"{first['text']!r} / {again['text']!r}, "
                                 f"served {served}, after the failover "
                                 f"{failed_over}, nodes {states}, "
                                 f"failures {node_b.failures}")
        # the router's added latency (node A only; node B is offline)
        out["federation"] = {
            "launches": fed, "served": served,
            "after_failover": failed_over,
            "failures_after_sweeps": node_b.failures,
            "nodes": states, "router_cost": _router_cost(
                server.url, router.url, {**chat, "max_tokens": 2})}
    finally:
        if router is not None:
            router.shutdown()
        if second is not None:
            second.close()
        if server is not None:
            server.shutdown()
        _env(saved)
        sm = server = second = router = None
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base_mem
    out["left_gb"] = left / 1e9
    if left > 0.25e9:
        raise AssertionError(f"http surfaces: {left / 1e9:.2f} GB left on "
                             "the card after teardown")
    out["phase_s"] = time.monotonic() - t_phase
    print(f"http surfaces ({card}): " + json.dumps(
        {k: v for k, v in out.items() if k != "ui"}
        | {"ui": {k: v for k, v in out["ui"].items() if k != "text"}}),
        flush=True)
    return out


def _entry(name, source, replaces, launches, rec) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


# -- the worker tier (ROADMAP item 23 part 2) ---------------------------------

WORKER_MODEL = "llama3-8b-bf16-worker"
WORKER_REF = "llama3-8b-bf16-in-process"
WORKER_NEW = 24                  # max_tokens of each chat
WORKER_TOKEN = "smoke-worker-token"
WORKER_EMBEDS = 2                # Embedding calls over the worker's client


def _card_used_gb() -> float:
    """GB the card holds for live work: every process's use
    (``mem_get_info``), less this process's allocator cache (free blocks
    it keeps for its own reuse; a long-lived small block, such as a cuBLAS
    workspace, can pin a large freed segment past ``empty_cache``)."""
    free, total = torch.cuda.mem_get_info()
    cache = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    return (total - free - cache) / 1e9


def _worker_report(what: str, report: Optional[dict], L: int,
                   embeds: Optional[int] = None) -> dict:
    """A worker's launch report, held to its own counters: K1 = L x its
    decode steps, K3 = L x its Embedding calls (``embeds``, when given;
    else none), the other kernels 0."""
    if report is None:
        raise AssertionError(f"{what}: the worker printed no launch report")
    n = report["launches"]
    want = {"paged_decode_attention": L * report["decode_steps"],
            "prefill_attention": L * report["embeddings"]}
    if embeds is not None and report["embeddings"] != embeds:
        raise AssertionError(f"{what}: {report['embeddings']} Embedding "
                             f"calls counted, {embeds} made")
    for k, v in n.items():
        if v != want.get(k, 0):
            raise AssertionError(f"{what}: {k} launched {v} times, expected "
                                 f"{want.get(k, 0)} ({report})")
    return report


def _wait_pids_gone(pids, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    left = set(pids)
    while left and time.monotonic() < deadline:
        for pid in list(left):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                left.discard(pid)
        time.sleep(0.1)
    if left:
        raise AssertionError(f"worker processes {sorted(left)} outlived "
                             "their stop")


def _settle_card() -> float:
    """Free what this process no longer uses (its garbage, its cuBLAS
    workspaces, its allocator cache), then ``_card_used_gb``."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return _card_used_gb()


def _wait_card_back(to_gb: float, slack_gb: float, what: str,
                    timeout: float = 60.0) -> float:
    """Wait until the card's use falls to ``to_gb`` + ``slack_gb`` (a dead
    process's context is reclaimed by the driver shortly after it dies;
    a tensor freed by a thread that just ended stays cached until the
    next ``empty_cache``); returns the use then."""
    deadline = time.monotonic() + timeout
    used = _settle_card()
    while used > to_gb + slack_gb and time.monotonic() < deadline:
        time.sleep(0.2)
        used = _settle_card()
    if used > to_gb + slack_gb:
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
        raise AssertionError(
            f"{what}: the card holds {used:.2f} GB for live work, "
            f"{used - to_gb:.2f} GB over {to_gb:.2f} GB (this process: "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; "
            f"processes on the card: {apps or 'none listed'})")
    return used


def phase_worker_tier(card: str) -> dict:
    """The worker tier on the card, through ``cli.main.build_server`` over
    HTTP, with no fallback:
      (a) ``backend: worker`` at Llama-3-8B's full width and depth
          (``debug:llama3-8b``, seeded bf16 weights drawn on the card in
          the worker, bf16 paged at bt 64) beside the same YAML without
          the backend (the engine in this process, the same weights): a
          streamed chat's greedy text is the in-process engine's; an
          Embedding over the model's own client equals ``runner.embed``
          within 1e-3 of its largest magnitude, TokenizeString the
          tokenizer's ids; the worker stops in order and its launch report
          gives K1 = 32 x its decode steps and K3 = 32 x its Embedding
          calls; the next chat spawns a fresh worker; SIGKILL of it: the
          chat after respawns it with the same text, and the card gets the
          dead process's memory back;
      (b) a fleet of worker processes (``--fleet-replicas 2
          --fleet-prefill-replicas 1 --fleet-disagg-threshold 512
          --fleet-device-pinning``: three workers on one card, unpinned
          with the warning) of an ``SMOKE_LAYERS["fleet"]``-layer
          checkpoint at the same widths: routed chats equal a single
          engine's texts; a 1100-token prompt prefills on ``p0`` and its
          PrefixChunks cross PrefillPrefix → TransferPrefix to a decode
          worker that resumes without prefilling them; SIGKILL of the
          decode worker a prompt routes to gives a failover with the same
          text and a respawned process; every decode worker that stops in
          order reports K1 = L x its decode steps, K2–K5 0;
      (c) a remote worker (``cli.main worker`` in a subprocess on
          loopback) registered into that fleet through ``POST
          /federated/register`` with the peer token (a wrong one is a
          401): the short chat the router sends it equals the reference;
          SIGKILL of it: evicted, never respawned by the pool; restarted
          on its port: redialed and rejoined;
      (d) no worker process is left (by pid) and the card holds at most
          0.25 GB more than before the phase."""
    import logging

    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    L = DEBUG_PRESETS["llama3-8b"].num_layers
    LF = SMOKE_LAYERS["fleet"]
    t_phase = time.monotonic()
    # the workers' own log lines (forwarded by their tails), timestamped:
    # where a spawn's seconds go
    tail_log = logging.getLogger("localai_tpu_torch.worker.process")
    tail_handler = logging.StreamHandler(sys.stdout)
    tail_handler.setFormatter(logging.Formatter("%(relativeCreated).0fms "
                                                "%(message)s"))
    tail_log.addHandler(tail_handler)
    tail_log.setLevel(logging.INFO)
    repo = str(Path(__file__).resolve().parent)
    root = Path(_scratch_dir("worker-", 7_000_000_000))
    models = root / "models"
    models.mkdir()
    engine = {"dtype": "bfloat16", "kv_dtype": "bfloat16", "max_slots": 4,
              "kv_block_tokens": 64}
    base = {"model": "debug:llama3-8b", "seed": 17, "context_size": 2048,
            "engine": engine}
    (models / f"{WORKER_REF}.yaml").write_text(json.dumps(
        {"name": WORKER_REF, **base}))
    (models / f"{WORKER_MODEL}.yaml").write_text(json.dumps(
        {"name": WORKER_MODEL, "backend": "worker", **base}))
    torch.cuda.synchronize()
    used0 = _settle_card()
    # every worker is a fresh interpreter; where the environment forbids
    # bytecode files (PYTHONDONTWRITEBYTECODE) and torch ships without
    # them, each one compiles torch's sources on import (~10 s on the
    # card's host). The phase's processes share a bytecode cache under
    # its scratch directory instead, warmed by one import at the start
    env = {"LOCALAI_MODELS_PATH": models, "LOCALAI_ADDRESS": "127.0.0.1",
           "LOCALAI_PORT": "0", "LOCALAI_CONFIG_PATH": root / "conf",
           "LOCALAI_UPLOAD_PATH": root / "uploads",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PYTHONPYCACHEPREFIX": root / "pycache",
           "PYTHONDONTWRITEBYTECODE": None}
    out = {"card": card, "layers": L, "fleet_layers": LF,
           "card_used_before_gb": used0}
    pids: set = set()
    saved = _env(env)
    warm = subprocess.Popen([sys.executable, "-c",
                             "import localai_tpu_torch.models.manager"])
    server = None
    try:
        # (a) backend: worker at full width and depth
        server = build_server(["run"]).start()
        url = server.url + "/v1/chat/completions"
        chat = {"max_tokens": WORKER_NEW, "temperature": 0,
                "logit_bias": ASCII_ONLY,
                "messages": [{"role": "user",
                              "content": "Say hello from the worker."}]}
        ref_sm = server.manager.get(WORKER_REF)
        ref = _sse_chat(url, {**chat, "model": WORKER_REF})
        toks = ref_sm.tokenizer.encode("embed this through the worker",
                                       add_bos=True)
        ref_vec = np.asarray(ref_sm.runner.embed(toks), np.float32)
        t0 = time.monotonic()
        warm.wait(120)
        out["bytecode_warm_wait_s"] = time.monotonic() - t0
        before_spawn = _card_used_gb()
        t0 = time.monotonic()
        wsm = server.manager.get(WORKER_MODEL)
        spawn_s = time.monotonic() - t0
        pool = server.manager.pool()
        wp = pool.process(WORKER_MODEL)
        pids.add(wp.pid)
        got = _sse_chat(url, {**chat, "model": WORKER_MODEL})
        client = wsm.client()
        vecs = [np.asarray(client.embedding(tokens=toks), np.float32)
                for _ in range(WORKER_EMBEDS)]
        emb_err = max(float(np.abs(v - ref_vec).max()) for v in vecs)
        text_ids = client.tokenize("Tokenize me, worker", add_bos=True)
        peak = _card_used_gb()
        if (got["text"] != ref["text"] or not ref["text"].strip()
                or got["completion_tokens"] != WORKER_NEW
                or emb_err > 1e-3 * float(np.abs(ref_vec).max())
                or text_ids != ref_sm.tokenizer.encode(
                    "Tokenize me, worker", add_bos=True)):
            raise AssertionError(f"worker (a): text {got['text']!r} vs "
                                 f"{ref['text']!r}, embedding error "
                                 f"{emb_err}, ids {text_ids[:8]}")
        pool.shutdown(WORKER_MODEL)            # SIGTERM: an orderly stop
        rep_a = _worker_report(f"{WORKER_MODEL} worker", wp.launch_report,
                               L, embeds=WORKER_EMBEDS)
        after_stop = _wait_card_back(before_spawn, 0.25,
                                     "worker (a) orderly stop")
        print(f"worker (a): spawn-to-ready {spawn_s:.1f}s, card "
              f"{before_spawn:.2f} GB before, {peak:.2f} GB at the "
              f"worker's peak, {after_stop:.2f} GB after its stop "
              f"({peak - after_stop:.2f} GB freed)", flush=True)
        # the next chat spawns a fresh worker
        t0 = time.monotonic()
        again = _sse_chat(url, {**chat, "model": WORKER_MODEL})
        respawn_s = time.monotonic() - t0
        wp2 = pool.process(WORKER_MODEL)
        pids.add(wp2.pid)
        if again["text"] != ref["text"] or wp2.pid == wp.pid:
            raise AssertionError(f"worker (a): respawned text "
                                 f"{again['text']!r}, pid {wp2.pid}")
        # SIGKILL: the card gets the process's memory back, the chat after
        # respawns it with the same text
        peak2 = _card_used_gb()
        wp2.proc.kill()
        wp2.proc.wait(30)
        after_kill = _wait_card_back(before_spawn, 0.25,
                                     "worker (a) after SIGKILL")
        t0 = time.monotonic()
        third = _sse_chat(url, {**chat, "model": WORKER_MODEL})
        kill_respawn_s = time.monotonic() - t0
        wp3 = pool.process(WORKER_MODEL)
        pids.add(wp3.pid)
        if third["text"] != ref["text"] or wp3.pid == wp2.pid:
            raise AssertionError(f"worker (a): after SIGKILL text "
                                 f"{third['text']!r}, pid {wp3.pid}")
        pool.shutdown(WORKER_MODEL)
        rep_a3 = _worker_report(f"{WORKER_MODEL} respawned worker",
                                wp3.launch_report, L, embeds=0)
        after_stop3 = _wait_card_back(before_spawn, 0.25,
                                      "worker (a) last stop")
        print(f"worker (a): respawn after a stop {respawn_s:.1f}s, after "
              f"SIGKILL {kill_respawn_s:.1f}s (spawn, load and one chat); "
              f"card {peak2:.2f} GB before the kill, {after_kill:.2f} GB "
              f"after it ({peak2 - after_kill:.2f} GB freed), "
              f"{after_stop3:.2f} GB after the last stop", flush=True)
        out["a"] = {"text": ref["text"], "spawn_to_ready_s": spawn_s,
                    "respawn_s": respawn_s,
                    "kill_respawn_s": kill_respawn_s,
                    "embedding_max_abs_err": emb_err,
                    "worker_peak_gb": peak - before_spawn,
                    "freed_at_stop_gb": peak - after_stop,
                    "freed_at_kill_gb": peak2 - after_kill,
                    "reports": [rep_a, rep_a3]}
        server.shutdown()
        server = ref_sm = wsm = client = None
        gc.collect()
        torch.cuda.empty_cache()
        out["b"], out["c"] = _worker_fleet(root, LF, pids)
        out["fleet_launches"] = sum(
            r["launches"]["paged_decode_attention"]
            for r in out["b"]["reports"])
    finally:
        if warm.poll() is None:
            warm.kill()
        if server is not None:
            server.shutdown()
        _env(saved)
        tail_log.removeHandler(tail_handler)
        tail_log.setLevel(logging.NOTSET)
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    # (d) no worker left, the card as before
    _wait_pids_gone(pids)
    out["card_used_after_gb"] = _wait_card_back(used0, 0.25,
                                                "worker tier teardown")
    out["launches"] = {
        "paged_decode_attention": sum(
            r["launches"]["paged_decode_attention"]
            for r in out["a"]["reports"]),
        "prefill_attention": sum(r["launches"]["prefill_attention"]
                                 for r in out["a"]["reports"])}
    out["phase_s"] = time.monotonic() - t_phase
    print("worker_tier: " + json.dumps(out), flush=True)
    return out


# -- tensor parallelism (ROADMAP item 19 part 1) ------------------------------

TP_MODEL = "llama3-8b-bf16-tp2"
TP_SMALL = "small-f32-tp2"
TP_NEW = 16                        # max_tokens of each chat
TP_GREEDY = 16                     # greedy tokens held to one card's
TP_EMBEDS = 2                      # inputs of the embedding request
TP_SEED = 23
# bf16 logits of the model=2 engine against one card: each rank's partial
# products of the two row-parallel weights are rounded to bf16 before the
# sum (one extra rounding of ~2^-9 relative a reduction, 64 reductions
# deep) and the two halves of each dot product are summed apart; on these
# random weights that moves a logit by a few hundredths of the largest
TP_LOGITS_TOL = 0.05


def _shapes(tree):
    """Every leaf shape of a ``param_shapes`` tree."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _shapes(v)
        else:
            yield v


def _tp_reports(before: int) -> list:
    from localai_tpu_torch.parallel import multihost as mh

    return mh.REPORTS[before:]


def _tp_nccl_one() -> dict:
    """An NCCL group of one on the card: each collective of the trunk
    (the row-parallel ``all_reduce`` through ``overlap.Reduce`` with its
    event timing, ``gather_vocab``'s all-gather and the vocab-parallel
    embedding's all-reduce) runs once on card tensors."""
    from localai_tpu_torch.parallel import mesh as pm
    from localai_tpu_torch.parallel import overlap as ovl

    backend = pm.initialize(f"127.0.0.1:{_free_port()}", 1, 0, "cuda:0")
    try:
        mesh = pm.build_mesh(pm.MeshPlan(model=1))
        x = torch.randn(4, 1, 4096, device="cuda").to(torch.bfloat16)
        red = ovl.Reduce(mesh)
        got = red(x.clone())
        logits = torch.randn(4, 1000, device="cuda")
        rows = ovl.embed_local(torch.randn(64, 32, device="cuda"),
                               torch.tensor([[1, 63]], device="cuda"),
                               torch.float32, mesh)
        torch.cuda.synchronize()
        ok = (torch.equal(got, x)
              and torch.equal(ovl.gather_vocab(logits, mesh), logits)
              and tuple(rows.shape) == (1, 2, 32))
        out = {"backend": backend, "ok": ok, "reduce_calls": red.calls,
               "reduce_ms": red.seconds * 1e3}
    finally:
        pm.destroy()
    print("tensor_parallel nccl group of one: " + json.dumps(out),
          flush=True)
    if backend != "nccl" or not ok or out["reduce_calls"] != 1 \
            or not out["reduce_ms"] > 0:
        raise AssertionError(f"NCCL group of one: {out}")
    return out


def _tp_small_parity(root: Path, kernels: dict) -> dict:
    """float32 debug:small: greedy streams of the model=2 engine (both
    ranks on the card over gloo; one card a rank over NCCL where two are
    visible) equal one card's, byte for byte; K1 launches L a decode step
    on the leader."""
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.engine.scheduler import GenRequest
    from localai_tpu_torch.models.manager import ModelManager

    models = root / "small-models"
    models.mkdir()
    (models / f"{TP_SMALL}.yaml").write_text(json.dumps({
        "name": TP_SMALL, "model": "debug:small", "seed": 5,
        "context_size": 512, "engine": {
            "dtype": "float32", "kv_dtype": "float32", "max_slots": 4,
            "kv_block_tokens": 16}}))
    prompts = [list(b"tensor parallel on one card"), list(b"abcabcabcabc"),
               list(b"the follower replays every call")]
    streams, launches = {}, {}
    for width in (1, 2):
        loader = ConfigLoader(models)
        loader.load_from_path(context_size=512)
        # model=1: one card, where more than one would auto-mesh it
        mgr = ModelManager(AppConfig(
            model_path=str(models), device="cuda",
            mesh_shape={"model": width}), loader)
        try:
            for w in kernels.values():
                w.launches = 0
            sm = mgr.get(TP_SMALL)
            hs = [sm.scheduler.submit(GenRequest(
                prompt=p, max_new_tokens=24, temperature=0.0))
                for p in prompts]
            streams[width] = [h.result(300).token_ids for h in hs]
            launches[width] = (kernels["paged_decode_attention"].launches,
                               sm.runner.decode_steps)
            backend = getattr(sm.runner.mesh, "backend", "")
        finally:
            mgr.shutdown()
    L = 4
    # one card a rank over NCCL where two cards are visible, else both
    # ranks on the one card over gloo
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    out = {"streams_equal": streams[1] == streams[2],
           "tokens": sum(len(s) for s in streams[2]),
           "k1": launches[2][0], "decode_steps": launches[2][1],
           "backend": backend}
    print("tensor_parallel small parity: " + json.dumps(out), flush=True)
    if want == "gloo":
        print("tensor_parallel: model=2 over NCCL (one card a rank) not "
              "run: one card visible", flush=True)
    if (not out["streams_equal"] or launches[2][0] != L * launches[2][1]
            or backend != want):
        raise AssertionError(f"model=2 small parity: {out}; streams "
                             f"{streams}")
    return out


def phase_tensor_parallel(card: str) -> dict:
    """Tensor parallelism on the card (ROADMAP item 19 part 1):
      (a) an NCCL group of one: each collective of the reductions once;
      (b) float32 debug:small at ``model=2`` gives one card's greedy
          streams byte for byte: both ranks on the card over gloo on CUDA
          tensors, or one card a rank over NCCL where two cards are
          visible (else it says that run did not happen);
      (c) ``llama3-8b-bf16-tp2`` (Llama-3-8B's full width and depth,
          seeded bf16 weights drawn shard by shard, bf16 paged at bt 64, 4
          slots) served through ``cli.main.build_server(["run", "--mesh",
          "model=2"])``: the leader (this process) spawns its follower
          rank on the same card (on the second where there are two);
          three streamed chats, one embedding
          request of two inputs, a prefill's logits, 16 timed decode
          steps. K1 = 32 x decode steps and K3 = 32 x (embedded inputs +
          logits prefills) on each rank, the follower's from its stop
          report; the follower's decode steps and token digest equal the
          leader's; the leader holds half the weights (bytes) and the
          follower about half (the card's use); the card gets the
          follower's and the leader's memory back after shutdown;
      (d) one card, the same seed: the prefill's logits within
          ``TP_LOGITS_TOL`` of the largest, the greedy tokens that agree
          with the model=2 engine's reported (not asserted: bf16 on random
          weights);
      plus K1 and K3 at a rank's local shape (16 q / 4 kv heads), timed
      beside their plain versions and SDPA for the kernels line."""
    import logging

    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler
    from localai_tpu_torch.models.llama import param_shapes
    from localai_tpu_torch.models.registry import (
        DEBUG_PRESETS,
        resolve_model,
    )

    L = DEBUG_PRESETS["llama3-8b"].num_layers
    t_phase = time.monotonic()
    tail_log = logging.getLogger("localai_tpu_torch.parallel.multihost")
    tail_handler = logging.StreamHandler(sys.stdout)
    tail_handler.setFormatter(logging.Formatter("%(relativeCreated).0fms "
                                                "%(message)s"))
    tail_log.addHandler(tail_handler)
    tail_log.setLevel(logging.INFO)
    repo = str(Path(__file__).resolve().parent)
    root = Path(_scratch_dir("tensor-parallel-", 1_000_000_000))
    models = root / "models"
    models.mkdir()
    (models / f"{TP_MODEL}.yaml").write_text(json.dumps({
        "name": TP_MODEL, "model": "debug:llama3-8b", "seed": TP_SEED,
        "context_size": 2048, "embeddings": True,
        "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                   "max_slots": 4, "kv_block_tokens": 64}}))
    # the follower is a fresh interpreter: a bytecode cache shared with a
    # warm-up import (as the worker tier phase's processes share one)
    env = {"LOCALAI_MODELS_PATH": models, "LOCALAI_ADDRESS": "127.0.0.1",
           "LOCALAI_PORT": "0", "LOCALAI_CONFIG_PATH": root / "conf",
           "LOCALAI_UPLOAD_PATH": root / "uploads",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PYTHONPYCACHEPREFIX": root / "pycache",
           "PYTHONDONTWRITEBYTECODE": None}
    saved = _env(env)
    warm = subprocess.Popen([sys.executable, "-c",
                             "import localai_tpu_torch.models.manager"])
    kernels = _all_kernels()
    out = {"card": card, "layers": L}
    server = sm = None
    try:
        out["nccl"] = _tp_nccl_one()
        warm.wait(120)
        t0 = time.monotonic()
        out["small"] = _tp_small_parity(root, kernels)
        out["small"]["s"] = time.monotonic() - t0
        torch.cuda.synchronize()
        used0 = _settle_card()
        alloc0 = torch.cuda.memory_allocated()
        # the follower's card: the leader's own where one card is visible
        fcard = 1 if torch.cuda.device_count() >= 2 else 0
        free1, total1 = torch.cuda.mem_get_info(fcard)
        for w in kernels.values():
            w.launches = 0
        before = len(_tp_reports(0))
        t0 = time.monotonic()
        server = build_server(["run", "--mesh", "model=2"]).start()
        sm = server.manager.get(TP_MODEL)
        torch.cuda.synchronize()
        out["load_s"] = time.monotonic() - t0
        runner = sm.runner
        cfg = DEBUG_PRESETS["llama3-8b"]
        if (type(runner).__name__ != "MirroredRunner" or runner.mesh.tp != 2
                or runner.local_cfg.num_heads != cfg.num_heads // 2
                or runner.local_cfg.num_kv_heads != cfg.num_kv_heads // 2):
            raise AssertionError(f"tp2: engine {type(runner).__name__}, "
                                 f"mesh {runner.mesh}")
        full = 2 * sum(math.prod(s) for s in _shapes(param_shapes(
            cfg)))                              # its bf16 weight bytes
        lead_w = _tree_bytes(runner.params)
        used_load = _card_used_gb()
        out.update(backend=runner.mesh.backend,
                   mode=runner.reduce.mode,
                   jax_mode=runner.overlap_mode,
                   jax_mode_why=runner.overlap_why,
                   leader_weights_gb=lead_w / 1e9,
                   card_used_by_group_gb=used_load - used0,
                   leader_reserved_gb=torch.cuda.memory_reserved() / 1e9)
        # on a shared card: what the group added less what this process
        # allocated (``_card_used_gb`` already leaves out its cache)
        out["follower_share_gb"] = (
            out["card_used_by_group_gb"]
            - (torch.cuda.memory_allocated() - alloc0) / 1e9
            if fcard == 0 else
            (free1 - torch.cuda.mem_get_info(fcard)[0]) / 1e9)
        # the card's use by the follower (its weights, pool, context and,
        # on its own card, NCCL's buffers): half the weights and more, far
        # from a whole copy; its exact weight bytes come in its report
        if not (0.49 * full < lead_w < 0.51 * full) or not (
                0.4 * full / 1e9 < out["follower_share_gb"]
                < 0.85 * full / 1e9):
            raise AssertionError(f"tp2 memory a rank: {out}")
        url = server.url + "/v1/chat/completions"
        chats = [{"model": TP_MODEL, "max_tokens": TP_NEW, "temperature": 0,
                  "logit_bias": ASCII_ONLY,
                  "messages": [{"role": "user", "content": q}]}
                 for q in ("Say hello from two ranks.",
                           "Name three colours.", "Count to five.")]
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda b: _sse_chat(url, b), chats))
        emb = json.loads(_post(server.url + "/v1/embeddings", {
            "model": TP_MODEL, "input": ["two ranks", "one card"]}).read())
        vecs = [np.asarray(d["embedding"]) for d in emb["data"]]
        ids = sm.tokenizer.encode("Tensor parallelism splits each layer "
                                  "over the ranks.", add_bos=True)
        tp_logits = runner.prompt_logits(ids)
        tp_greedy = sm.scheduler.generate(GenRequest(
            prompt=ids, max_new_tokens=TP_GREEDY, temperature=0.0),
            timeout=300).token_ids
        # the decode step's wall and its reductions' share (CUDA events
        # on the leader's stream around each all_reduce)
        steps0, calls0, secs0 = (runner.decode_steps, runner.reduce.calls,
                                 runner.reduce.seconds)
        runner.step_n(2)
        t0 = time.monotonic()
        runner.step_n(16)
        step_ms = (time.monotonic() - t0) * 1e3 / 16
        out.update(
            chats=[{k: c[k] for k in ("text", "ttft_s", "wall_s",
                                      "completion_tokens")} for c in got],
            tokens_per_s=sum(c["completion_tokens"] for c in got)
            / max(c["wall_s"] for c in got),
            step_ms=step_ms,
            collective_ms_per_step=(runner.reduce.seconds - secs0) * 1e3
            / (runner.decode_steps - steps0),
            reductions_per_step=(runner.reduce.calls - calls0)
            / (runner.decode_steps - steps0))
        if (any(not c["text"] or c["completion_tokens"] != TP_NEW
                for c in got) or len(vecs) != TP_EMBEDS
                or not all(np.isfinite(v).all() for v in vecs)
                or not np.isfinite(tp_logits).all()):
            raise AssertionError(f"tp2 serve: {out}")
        decode_steps = runner.decode_steps
        digest = runner.digest.hexdigest()
        lead = {k: w.launches for k, w in kernels.items()}
        k3_calls = TP_EMBEDS + 1          # embedded inputs + logits prefill
        want = {"paged_decode_attention": L * decode_steps,
                "prefill_attention": L * k3_calls}
        if {k: lead[k] for k in want} != want or any(
                v for k, v in lead.items() if k not in want):
            raise AssertionError(f"tp2 leader launches {lead}, expected "
                                 f"{want}")
        server.shutdown()
        server = sm = runner = None
        reports = _tp_reports(before)
        if len(reports) != 1:
            raise AssertionError(f"tp2: follower reports {reports}")
        rep = reports[0]
        rm = rep["models"][TP_MODEL]
        fl = rep["launches"]
        out["follower_weights_gb"] = rm["weight_bytes"] / 1e9
        if (rm["digest"] != digest or rm["decode_steps"] != decode_steps
                or rm["weight_bytes"] != lead_w
                or fl["paged_decode_attention"] != L * rm["decode_steps"]
                or fl["prefill_attention"] != L * (
                    rm["calls"].get("embed", 0)
                    + rm["calls"].get("prompt_logits", 0))
                or rm["calls"].get("embed", 0) != TP_EMBEDS
                or rep["errors"]):
            raise AssertionError(f"tp2 follower report {rep}; leader "
                                 f"digest {digest}, {decode_steps} steps")
        out.update(decode_steps=decode_steps, digest=digest,
                   leader_launches=lead, follower_launches=fl,
                   follower_calls=rm["calls"])
        gc.collect()
        out["card_used_after_gb"] = _wait_card_back(
            used0, 0.5, "tensor-parallel shutdown")
        if fcard:
            out["follower_card_left_gb"] = (
                free1 - torch.cuda.mem_get_info(fcard)[0]) / 1e9
            if out["follower_card_left_gb"] > 0.5:
                raise AssertionError(f"tp2: the follower's card holds "
                                     f"{out['follower_card_left_gb']} GB "
                                     "after shutdown")
        # (d) one card, the same seed
        one = resolve_model("debug:llama3-8b", dtype="bfloat16",
                            seed=TP_SEED, device="cuda")
        r1 = ModelRunner(one.cfg, one.params, num_slots=4, max_ctx=2048,
                         kv_dtype="bfloat16", kv_block_tokens=64,
                         device="cuda")
        ref = r1.prompt_logits(ids)
        r1.step_n(2)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        r1.step_n(16)
        out["one_card_step_ms"] = (time.monotonic() - t0) * 1e3 / 16
        err = float(np.abs(tp_logits - ref).max())
        scale = float(np.abs(ref).max())
        sched1 = Scheduler(r1, one.tokenizer)
        try:
            one_greedy = sched1.generate(GenRequest(
                prompt=ids, max_new_tokens=TP_GREEDY, temperature=0.0),
                timeout=300).token_ids
        finally:
            sched1.shutdown()
        agree = 0
        for a, b in zip(tp_greedy, one_greedy):
            if a != b:
                break
            agree += 1
        out.update(logits_max_abs_err=err, logits_max_abs=scale,
                   logits_tol=TP_LOGITS_TOL * scale,
                   argmax_agree=float(np.mean(tp_logits.argmax(-1)
                                              == ref.argmax(-1))),
                   greedy_prefix_agree=agree, greedy_len=len(tp_greedy))
        del one, r1, sched1
        if err > TP_LOGITS_TOL * scale:
            raise AssertionError(f"tp2 logits against one card: {err} > "
                                 f"{TP_LOGITS_TOL} x {scale}")
        # K1 and K3 at a rank's local shape, for the kernels line
        out["k1"] = kernel_case("k1-tp2-bf16", torch.bfloat16, S=4, Hq=16,
                                Hkv=4, MB=32,
                                positions=(2047, 1300, 700, 100),
                                timed=True)
        out["k3"] = prefill_case("k3-tp2-bf16-T128", torch.bfloat16, 128,
                                 Hq=16, Hkv=4)
    finally:
        if warm.poll() is None:
            warm.kill()
        if server is not None:
            server.shutdown()
        _env(saved)
        tail_log.removeHandler(tail_handler)
        tail_log.setLevel(logging.NOTSET)
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {
        k: out["leader_launches"][k] + out["follower_launches"][k]
        for k in ("paged_decode_attention", "prefill_attention")}
    out["phase_s"] = time.monotonic() - t_phase
    print("tensor_parallel: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("k1", "k3")}),
        flush=True)
    return out


# -- sequence and pipeline parallelism (ROADMAP item 19 part 2) ---------------

SP_MODEL = "llama3-8b-bf16-sp2"
PP_MODEL = "llama3-8b-bf16-pp2"
SP_PROMPT_BYTES = 2000             # the long chat: one byte a token
SP_NEW = 16                        # max_tokens of each chat
SP_SEED = 29
PP_STAGE_GB = 9.08                 # a stage: half the layers, embed + head


def _seq_pipe_small(root: Path, kernels: dict) -> dict:
    """float32 debug:small at ``seq=2`` (paged; a threshold of 16 under
    every prompt: each admission takes the ring prefill into the pool) and
    at ``pipe=2`` (contiguous, two layers a stage), both ranks on the card
    (over gloo; NCCL where two cards are visible): greedy streams equal
    one card's on the same layout, byte for byte."""
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.engine.scheduler import GenRequest
    from localai_tpu_torch.models.manager import ModelManager

    models = root / "sp-small-models"
    models.mkdir()
    for name, paged in (("s", True), ("c", False)):
        (models / f"{name}.yaml").write_text(json.dumps({
            "name": name, "model": "debug:small", "seed": 5,
            "context_size": 512, "engine": {
                "dtype": "float32", "kv_dtype": "float32", "max_slots": 4,
                "kv_block_tokens": 16, "sp_prefill_threshold": 16,
                "kv_paged": paged}}))
    prompts = [list(b"a ring over two ranks of one card"),
               list(b"abcabcabcabcabcabcabc"),
               list(b"the second stage hands the hidden on")]
    out = {}
    for name, shape in (("s", {"model": 1}), ("s", {"seq": 2}),
                        ("c", {"model": 1}), ("c", {"pipe": 2})):
        loader = ConfigLoader(models)
        loader.load_from_path(context_size=512)
        mgr = ModelManager(AppConfig(model_path=str(models), device="cuda",
                                     mesh_shape=shape), loader)
        try:
            for w in kernels.values():
                w.launches = 0
            sm = mgr.get(name)
            hs = [sm.scheduler.submit(GenRequest(
                prompt=p, max_new_tokens=24, temperature=0.0))
                for p in prompts]
            key = name + ":" + ",".join(f"{k}={v}" for k, v in shape.items())
            out[key] = {"streams": [h.result(300).token_ids for h in hs],
                        "path": sm.runner.last_prefill_path,
                        "sp_prefills": sm.runner.sp_prefills,
                        "paged": sm.runner.paged,
                        "backend": getattr(sm.runner.mesh, "backend", ""),
                        "launches": {k: w.launches
                                     for k, w in kernels.items()}}
        finally:
            mgr.shutdown()
    rec = {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
           for k, v in out.items()}
    rec["seq_equal"] = out["s:seq=2"]["streams"] == out["s:model=1"][
        "streams"]
    rec["pipe_equal"] = out["c:pipe=2"]["streams"] == out["c:model=1"][
        "streams"]
    print("seq_pipe small parity: " + json.dumps(rec), flush=True)
    if (not rec["seq_equal"] or not rec["pipe_equal"]
            or out["s:seq=2"]["path"] != "paged_sp"
            or out["s:seq=2"]["sp_prefills"] != len(prompts)
            or out["c:pipe=2"]["paged"]):
        raise AssertionError(f"seq/pipe small parity: {rec}; streams "
                             f"{ {k: v['streams'] for k, v in out.items()} }")
    return rec


def _serve_8b(mesh: str, kernels: dict) -> tuple:
    """``build_server(["run", "--mesh", mesh])`` over the models dir of
    the environment; (server, serving model, load s) once the follower
    joined."""
    from localai_tpu_torch.cli.main import build_server

    for w in kernels.values():
        w.launches = 0
    t0 = time.monotonic()
    server = build_server(["run", "--mesh", mesh]).start()
    name = SP_MODEL if mesh.startswith("seq") else PP_MODEL
    sm = server.manager.get(name)
    torch.cuda.synchronize()
    return server, sm, time.monotonic() - t0


def _follower(before: int, what: str) -> dict:
    reports = _tp_reports(before)
    if len(reports) != 1 or reports[0]["errors"]:
        raise AssertionError(f"{what}: follower reports {reports}")
    return reports[0]


def _timed_steps(runner, n: int = 16) -> float:
    """ms a decode step over ``n`` steps after two warm ones."""
    runner.step_n(2)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    runner.step_n(n)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / n


def _sp2(root: Path, kernels: dict, L: int, used0: float) -> dict:
    """(b) ``llama3-8b-bf16-sp2``: the long streamed chat takes the ring
    prefill on both ranks (K3 none in it), then two short chats; K1 = L x
    decode steps on each rank, digests equal; the ring prefill's wall on
    CUDA events; the ring's logits of the long prompt for (d)."""
    from localai_tpu_torch.engine.scheduler import GenRequest

    out = {}
    server = None
    before = len(_tp_reports(0))
    try:
        server, sm, out["load_s"] = _serve_8b("seq=2", kernels)
        runner = sm.runner
        inner = runner._runner
        if (type(runner).__name__ != "MirroredRunner"
                or runner.mesh.shape["seq"] != 2 or not runner.sp_enabled
                or not runner.paged or runner.sp_threshold != 1024):
            raise AssertionError(f"sp2: engine {type(runner).__name__}, "
                                 f"mesh {runner.mesh}")
        out["weights_gb"] = _tree_bytes(inner.params) / 1e9
        out["backend"] = runner.mesh.backend
        ring = {"ms": [], "k3": [], "hops": [], "hop_ms": [],
                "gather_ms": []}
        real = inner._prefill_paged_sp_prog
        hops, gathers = (inner.transfers[k]
                         for k in ("ring_hop", "kv_gather"))

        def timed(*a, **k):
            k3 = kernels["prefill_attention"].launches
            h0, hs0, gs0 = hops.calls, hops.seconds, gathers.seconds
            ms, tok = _events_ms(lambda: real(*a, **k))
            ring["ms"].append(ms)
            ring["k3"].append(kernels["prefill_attention"].launches - k3)
            # the split of the wall: the ring's hops (one K/V exchange a
            # layer) and the K/V all-gather, on CUDA events; the rest is
            # the chunk's compute and the cache write
            ring["hops"].append(hops.calls - h0)
            ring["hop_ms"].append((hops.seconds - hs0) * 1e3)
            ring["gather_ms"].append((gathers.seconds - gs0) * 1e3)
            return tok

        inner._prefill_paged_sp_prog = timed
        url = server.url + "/v1/chat/completions"
        body = {"model": SP_MODEL, "max_tokens": SP_NEW, "temperature": 0,
                "logit_bias": ASCII_ONLY}
        long = _sse_chat(url, {**body, "messages": [
            {"role": "user", "content": _prose(SP_SEED, SP_PROMPT_BYTES)}]})
        shorts = [_sse_chat(url, {**body, "messages": [
            {"role": "user", "content": q}]})
            for q in ("Name two colours.", "Count to three.")]
        ids = sm.tokenizer.encode(_prose(SP_SEED + 1, SP_PROMPT_BYTES),
                                  add_bos=True)
        out["logits"] = runner.prompt_logits(ids)
        out["greedy"] = sm.scheduler.generate(GenRequest(
            prompt=ids, max_new_tokens=SP_NEW, temperature=0.0),
            timeout=300).token_ids
        out["ids"] = ids
        out["step_ms"] = _timed_steps(runner)
        inner._prefill_paged_sp_prog = real
        if (not (1024 <= long["prompt_tokens"] <= 2048)
                or long["completion_tokens"] != SP_NEW
                or any(not c["text"] for c in [long] + shorts)
                or ring["k3"] != [0, 0] or runner.sp_prefills != 2
                or ring["hops"] != [L, L]
                or not np.isfinite(out["logits"]).all()):
            raise AssertionError(f"sp2 serve: long {long}, ring {ring}, "
                                 f"{runner.sp_prefills} ring prefills")
        steps, digest = runner.decode_steps, runner.digest.hexdigest()
        lead = {k: w.launches for k, w in kernels.items()}
        if lead["paged_decode_attention"] != L * steps or any(
                v for k, v in lead.items() if k != "paged_decode_attention"):
            raise AssertionError(f"sp2 leader launches {lead}, {steps} "
                                 "steps")
        out.update(ring_prefill_ms=ring["ms"], ring_k3=ring["k3"],
                   ring_hops=ring["hops"], ring_hop_ms=ring["hop_ms"],
                   ring_kv_gather_ms=ring["gather_ms"],
                   long={k: long[k] for k in ("ttft_s", "wall_s",
                                              "prompt_tokens",
                                              "completion_tokens")},
                   short_ttft_s=[c["ttft_s"] for c in shorts],
                   card_used_gb=_card_used_gb() - used0)
        server.shutdown()
        # nothing of the engine may outlive it: the card check follows
        server = sm = runner = inner = None
        rep = _follower(before, "sp2")
        rm, fl = rep["models"][SP_MODEL], rep["launches"]
        if (rm["digest"] != digest or rm["decode_steps"] != steps
                or rm["sp_prefills"] != 2
                # the ring of both admissions and of prompt_logits
                or rm["transfers"]["ring_hop"]["calls"] != L * (
                    2 + rm["calls"].get("prompt_logits", 0))
                or fl["paged_decode_attention"] != L * steps
                or any(v for k, v in fl.items()
                       if k != "paged_decode_attention")):
            raise AssertionError(f"sp2 follower {rep}; leader {digest}, "
                                 f"{steps} steps")
        out.update(decode_steps=steps, digest=digest, leader_launches=lead,
                   follower_launches=fl, follower_weights_gb=rm[
                       "weight_bytes"] / 1e9,
                   follower_transfers=rm["transfers"])
    finally:
        if server is not None:
            server.shutdown()
        gc.collect()
    out["card_used_after_gb"] = _wait_card_back(used0, 0.5,
                                                "sp2 shutdown")
    return out


def _pp2(kernels: dict, L: int, used0: float) -> dict:
    """(c) ``llama3-8b-bf16-pp2``: each stage holds its 16 layers (9.08 GB
    with embed and lm_head), three streamed chats and a prefill's logits;
    K2 = 16 x decode steps and K3 = 16 x (fresh prefills + logits
    prefills) on each stage, digests equal; the step wall and the
    hand-offs' ms a step (CUDA events)."""
    from localai_tpu_torch.models.llama import param_shapes
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = DEBUG_PRESETS["llama3-8b"]
    shapes = param_shapes(cfg)
    stage = 2 * (sum(math.prod(s) for s in _shapes(shapes["layers"])) // 2
                 + sum(math.prod(s) for k, s in shapes.items()
                       if k != "layers"))
    out = {"stage_bytes": stage}
    server = None
    before = len(_tp_reports(0))
    try:
        server, sm, out["load_s"] = _serve_8b("pipe=2", kernels)
        runner = sm.runner
        inner = runner._runner
        if (not runner.pp_enabled or runner.paged
                or runner.local_cfg.num_layers != L // 2
                or runner.attn_impl != "xla"):
            raise AssertionError(f"pp2: engine {runner.mesh}, paged "
                                 f"{runner.paged}")
        lead_w = _tree_bytes(inner.params)
        out.update(weights_gb=lead_w / 1e9, backend=runner.mesh.backend,
                   card_used_gb=_card_used_gb() - used0)
        if lead_w != stage or abs(lead_w / 1e9 - PP_STAGE_GB) \
                > 0.02 * PP_STAGE_GB:
            raise AssertionError(f"pp2: the leader holds {lead_w} B, a "
                                 f"stage {stage} B")
        url = server.url + "/v1/chat/completions"
        chats = [{"model": PP_MODEL, "max_tokens": SP_NEW, "temperature": 0,
                  "logit_bias": ASCII_ONLY,
                  "messages": [{"role": "user", "content": q}]}
                 for q in ("Say hello from two stages.",
                           "Name three colours.", "Count to five.")]
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda b: _sse_chat(url, b), chats))
        ids = sm.tokenizer.encode("Pipeline parallelism splits the layers "
                                  "over the stages.", add_bos=True)
        out["logits"] = runner.prompt_logits(ids)
        out["ids"] = ids
        # the leader is stage 0: "sent" its hand-off to stage 1 (the
        # transfer; stage 1 waits in its receive), "waited" the final
        # hidden's broadcast (stage 1's 16 layers inside)
        hand = {k: runner.transfers[f"handoff_{k}"]
                for k in ("sent", "waited")}
        hand0 = {k: (t.calls, t.seconds) for k, t in hand.items()}
        steps0 = runner.decode_steps
        out["step_ms"] = _timed_steps(runner)
        n = runner.decode_steps - steps0
        for k, t in hand.items():
            out[f"handoff_{k}_ms_per_step"] = (
                t.seconds - hand0[k][1]) * 1e3 / n
            out[f"handoffs_{k}_per_step"] = (t.calls - hand0[k][0]) / n
        if any(not c["text"] or c["completion_tokens"] != SP_NEW
               for c in got) or not np.isfinite(out["logits"]).all():
            raise AssertionError(f"pp2 serve: {got}")
        steps, digest = runner.decode_steps, runner.digest.hexdigest()
        fresh = runner.fresh_prefills
        lead = {k: w.launches for k, w in kernels.items()}
        want = {"decode_attention": (L // 2) * steps,
                "prefill_attention": (L // 2) * (fresh + 1)}
        if {k: lead[k] for k in want} != want or any(
                v for k, v in lead.items() if k not in want):
            raise AssertionError(f"pp2 leader launches {lead}, expected "
                                 f"{want}")
        out["chats"] = [{k: c[k] for k in ("ttft_s", "wall_s",
                                           "completion_tokens")}
                        for c in got]
        server.shutdown()
        server = sm = runner = inner = None
        rep = _follower(before, "pp2")
        rm, fl = rep["models"][PP_MODEL], rep["launches"]
        if (rm["digest"] != digest or rm["decode_steps"] != steps
                or rm["weight_bytes"] != stage
                or fl["decode_attention"] != (L // 2) * steps
                or fl["prefill_attention"] != (L // 2) * (
                    rm["fresh_prefills"]
                    + rm["calls"].get("prompt_logits", 0))
                or any(v for k, v in fl.items() if k not in want)):
            raise AssertionError(f"pp2 follower {rep}; leader {digest}, "
                                 f"{steps} steps")
        # the follower is stage 1: "sent" is its broadcast of the final
        # hidden (the transfer; stage 0 waits in it), "waited" its receive
        # of stage 0's hidden, over the whole run
        out.update(decode_steps=steps, digest=digest, fresh_prefills=fresh,
                   leader_launches=lead, follower_launches=fl,
                   follower_weights_gb=rm["weight_bytes"] / 1e9,
                   follower_transfers=rm["transfers"])
    finally:
        if server is not None:
            server.shutdown()
        gc.collect()
    out["card_used_after_gb"] = _wait_card_back(used0, 0.5,
                                                "pp2 shutdown")
    return out


def _one_card_reference(sp: dict, pp: dict) -> dict:
    """(d) one card, the same seed: the ring prefill's logits and the
    stage chain's within ``TP_LOGITS_TOL`` of the largest; the ring
    prefill's wall beside one card's (chunked paged) prefill of the same
    prompt; one card's step; greedy agreement with the seq=2 engine's
    reported."""
    from localai_tpu_torch.engine.runner import ModelRunner
    from localai_tpu_torch.engine.scheduler import GenRequest, Scheduler
    from localai_tpu_torch.models.registry import resolve_model

    one = resolve_model("debug:llama3-8b", dtype="bfloat16", seed=SP_SEED,
                        device="cuda")
    r1 = ModelRunner(one.cfg, one.params, num_slots=4, max_ctx=4096,
                     kv_dtype="bfloat16", kv_block_tokens=64, device="cuda")
    out = {}
    try:
        for key, rec in (("sp", sp), ("pp", pp)):
            ref = r1.prompt_logits(rec.pop("ids"))
            got = rec.pop("logits")
            err, scale = float(np.abs(got - ref).max()), float(
                np.abs(ref).max())
            out[key] = {"logits_max_abs_err": err, "logits_max_abs": scale,
                        "logits_tol": TP_LOGITS_TOL * scale,
                        "argmax_agree": float(np.mean(
                            got.argmax(-1) == ref.argmax(-1)))}
            if err > TP_LOGITS_TOL * scale:
                raise AssertionError(f"{key}2 logits against one card: "
                                     f"{err} > {TP_LOGITS_TOL} x {scale}")
            del ref, got
        ids = one.tokenizer.encode(_prose(SP_SEED + 1, SP_PROMPT_BYTES),
                                   add_bos=True)
        slot = r1.acquire_slot()
        out["one_card_prefill_ms"], _ = _events_ms(
            lambda: r1.admit(slot, ids, temperature=0.0))
        r1.release(slot)
        out["one_card_step_ms"] = _timed_steps(r1)
        sched = Scheduler(r1, one.tokenizer)
        try:
            greedy = sched.generate(GenRequest(
                prompt=ids, max_new_tokens=SP_NEW, temperature=0.0),
                timeout=300).token_ids
        finally:
            sched.shutdown()
        agree = 0
        for a, b in zip(sp.pop("greedy"), greedy):
            if a != b:
                break
            agree += 1
        out["sp_greedy_prefix_agree"] = agree
    finally:
        del one, r1
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_seq_pipe(card: str) -> dict:
    """Sequence and pipeline parallelism on the card (ROADMAP item 19 part
    2, steps 2 and 3), both ranks on the one card over gloo (NCCL, a card
    a rank, where two are visible):
      (a) float32 debug:small at ``seq=2`` (every prompt past a threshold
          of 16: the ring prefill into the paged pool) and ``pipe=2``
          give one card's greedy streams byte for byte;
      (b) ``llama3-8b-bf16-sp2`` (Llama-3-8B's full width and depth,
          seeded bf16 weights, paged bf16 at bt 64, 4 slots) through
          ``build_server(["run", "--mesh", "seq=2"])``: one streamed chat
          of a ~2000-token prompt (past the default threshold of 1024),
          then two short ones; the ring prefill (``paged_sp``) on both
          ranks with no K3 launch in it, its wall split into the ring's
          hops (32 a prefill, K and V in one exchange) and the K/V
          all-gather; K1 = 32 x decode steps on each rank, the
          follower's from its stop report; digests equal;
      (c) ``llama3-8b-bf16-pp2`` through ``--mesh pipe=2`` (contiguous):
          9.08 GB of weights a stage (both; the follower's from its
          report); K2 = 16 x decode steps and K3 = 16 x prefills on each
          stage; digests equal; the step wall and each stage's
          hand-off spans, "sent" (its own sends: the transfer) apart
          from "waited" (its receives: the other stage's compute
          inside);
      (d) one card, the same seed: both engines' prefill logits within
          ``TP_LOGITS_TOL`` of the largest; the ring prefill's wall
          beside one card's prefill of the same prompt;
      (e) the card's memory back after each group's shutdown;
    plus K1, K2 and K3 at the served shapes for the kernels line."""
    import logging

    L = 32
    t_phase = time.monotonic()
    tail_log = logging.getLogger("localai_tpu_torch.parallel.multihost")
    tail_handler = logging.StreamHandler(sys.stdout)
    tail_handler.setFormatter(logging.Formatter("%(relativeCreated).0fms "
                                                "%(message)s"))
    tail_log.addHandler(tail_handler)
    tail_log.setLevel(logging.INFO)
    repo = str(Path(__file__).resolve().parent)
    root = Path(_scratch_dir("seq-pipe-", 1_000_000_000))
    models = root / "models"
    models.mkdir()
    for name in (SP_MODEL, PP_MODEL):
        (models / f"{name}.yaml").write_text(json.dumps({
            "name": name, "model": "debug:llama3-8b", "seed": SP_SEED,
            "context_size": 4096 if name == SP_MODEL else 2048,
            "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                       "max_slots": 4, "kv_block_tokens": 64}}))
    env = {"LOCALAI_MODELS_PATH": models, "LOCALAI_ADDRESS": "127.0.0.1",
           "LOCALAI_PORT": "0", "LOCALAI_CONFIG_PATH": root / "conf",
           "LOCALAI_UPLOAD_PATH": root / "uploads",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PYTHONPYCACHEPREFIX": root / "pycache",
           "PYTHONDONTWRITEBYTECODE": None}
    saved = _env(env)
    kernels = _all_kernels()
    out = {"card": card, "layers": L}
    try:
        t0 = time.monotonic()
        out["small"] = _seq_pipe_small(root, kernels)
        out["small"]["s"] = time.monotonic() - t0
        used0 = _settle_card()
        sp = _sp2(root, kernels, L, used0)
        pp = _pp2(kernels, L, used0)
        out["reference"] = _one_card_reference(sp, pp)
        out["sp2"], out["pp2"] = sp, pp
        out["k1"] = kernel_case("k1-sp2-bf16", torch.bfloat16, S=4, MB=64,
                                positions=(2047, 1300, 700, 100),
                                timed=True)
        out["k2"] = decode_case("k2-pp2-bf16", torch.bfloat16, S=4, C=2048,
                                positions=(2047, 1300, 700, 100),
                                timed=True)
        out["k3"] = prefill_case("k3-pp2-bf16-T128", torch.bfloat16, 128)
    finally:
        _env(saved)
        tail_log.removeHandler(tail_handler)
        tail_log.setLevel(logging.NOTSET)
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {
        "paged_decode_attention":
            sp["leader_launches"]["paged_decode_attention"]
            + sp["follower_launches"]["paged_decode_attention"],
        "decode_attention": pp["leader_launches"]["decode_attention"]
        + pp["follower_launches"]["decode_attention"],
        "prefill_attention": pp["leader_launches"]["prefill_attention"]
        + pp["follower_launches"]["prefill_attention"]}
    out["phase_s"] = time.monotonic() - t_phase
    print("seq_pipe: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("k1", "k2", "k3")}),
        flush=True)
    return out


def _prompt_cache(metrics: dict, key: str) -> int:
    """A worker's prefix-cache counter (0 before its first transfer
    attached the cache)."""
    return (metrics.get("prompt_cache") or {}).get(key, 0)


def _worker_fleet(root: Path, L: int, pids: set) -> tuple:
    """(b) and (c) of ``phase_worker_tier``: the fleet of worker processes
    and the remote worker. Returns their records."""
    from localai_tpu_torch.cli.main import build_server
    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.models.loader import write_llama_checkpoint
    from localai_tpu_torch.models.registry import DEBUG_PRESETS

    cfg = dataclasses.replace(DEBUG_PRESETS["llama3-8b"], dtype="bfloat16",
                              num_layers=L)
    models, ckpt = root / "fleet-models", root / "llama3-8b-worker-fleet"
    params = tl.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(19), "cuda")
    write_llama_checkpoint(ckpt, cfg, params, dtype="bfloat16")
    (ckpt / "config.json").write_text(json.dumps(
        {**LLAMA3_8B_CONFIG, "num_hidden_layers": L}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    models.mkdir()
    name = "llama3-8b-bf16-worker-fleet"
    (models / f"{name}.yaml").write_text(json.dumps(
        {"name": name, "model": str(ckpt), "context_size": 4096,
         "engine": {"dtype": "bfloat16", "kv_dtype": "bfloat16",
                    "max_slots": 8, "kv_block_tokens": 64}}))
    system = _prose(31, 256)
    bodies = {
        "affinity": [{"model": name, "max_tokens": 24, "temperature": 0,
                      "messages": [{"role": "system", "content": system},
                                   {"role": "user", "content": q}]}
                     for q in ("What is a worker?", "Name two primes.")],
        "long": {"model": name, "max_tokens": 24, "temperature": 0,
                 "messages": [{"role": "user",
                               "content": _prose(32, 1100)}]},
        "failover": {"model": name, "max_tokens": 24, "temperature": 0,
                     "messages": [{"role": "user",
                                   "content": _prose(33, 300)}]},
    }
    # a raw completion under one 64-token block (no chat template): no
    # affinity key, so least-loaded routing sends it to the replica that
    # never served, the remote worker just registered
    remote_body = {"model": name, "prompt": "hi remote", "max_tokens": 16,
                   "temperature": 0, "logit_bias": ASCII_ONLY}

    def text(resp):
        return resp["choices"][0]["message"]["content"]

    def chat(url, body):
        return json.loads(_post(url, body).read())

    def complete(base):
        return json.loads(_post(base + "/v1/completions",
                                remote_body).read())["choices"][0]["text"]

    # (c)'s remote worker starts now: its interpreter and torch load while
    # the reference and the fleet boot
    port = _free_port()
    cmd = [sys.executable, "-m", "localai_tpu_torch.cli.main", "worker",
           "--addr", f"127.0.0.1:{port}"]
    remote = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    pids.add(remote.pid)
    saved = _env({"LOCALAI_MODELS_PATH": models})
    server = None
    try:
        server = build_server(["run"]).start()
        url = server.url + "/v1/chat/completions"
        ref = {k: ([text(chat(url, b)) for b in v] if isinstance(v, list)
                   else text(chat(url, v))) for k, v in bodies.items()}
        ref["remote"] = complete(server.url)
    except BaseException:
        remote.kill()        # no worker outlives a failed phase
        raise
    finally:
        if server is not None:
            server.shutdown()
        _env(saved)
        server = None
        gc.collect()
        torch.cuda.empty_cache()
    saved = _env({"LOCALAI_MODELS_PATH": models,
                  "LOCALAI_PEER_TOKEN": WORKER_TOKEN,
                  "LOCALAI_FLEET_REDIAL_BASE_S": "0.5",
                  "LOCALAI_FLEET_REDIAL_CAP_S": "2"})
    b: dict = {}
    c: dict = {}
    try:
        t0 = time.monotonic()
        server = build_server([
            "run", "--fleet-replicas", "2", "--fleet-prefill-replicas", "1",
            "--fleet-disagg-threshold", str(FLEET_THRESHOLD),
            "--fleet-device-pinning"]).start()
        url = server.url + "/v1/chat/completions"
        fm = server.manager.get(name)
        b["boot_s"] = time.monotonic() - t0
        b["card_used_gb"] = _card_used_gb()
        members = fm.pool.members()
        if ({type(r).__name__ for r in members} != {"WorkerReplica"}
                or len(members) != 3):
            raise AssertionError(f"worker fleet: replicas {members}")
        pids.update(r.pid for r in members)
        got = [text(chat(url, bd)) for bd in bodies["affinity"]]
        if got != ref["affinity"]:
            raise AssertionError(f"worker fleet: affinity texts {got} vs "
                                 f"{ref['affinity']}")
        # the prefix handed across processes
        decs = {r.id: r.metrics() for r in members if r.role == "decode"}
        t0_transfers = fm.scheduler.prefix_transfers
        long_text = text(chat(url, bodies["long"]))
        after = {r.id: r.metrics() for r in members if r.role == "decode"}
        dest = [rid for rid in after
                if _prompt_cache(after[rid], "hits")
                > _prompt_cache(decs[rid], "hits")]
        chunks = {rid: after[rid]["prefill_chunks"]
                  - decs[rid]["prefill_chunks"] for rid in after}
        if (long_text != ref["long"]
                or fm.scheduler.prefix_transfers != t0_transfers + 1
                or len(dest) != 1
                or _prompt_cache(after[dest[0]], "hit_tokens")
                - _prompt_cache(decs[dest[0]], "hit_tokens") < 1024
                or chunks[dest[0]] > 1):
            raise AssertionError(f"worker fleet: handoff dest {dest}, "
                                 f"chunks {chunks}, transfers "
                                 f"{fm.scheduler.prefix_transfers}, text "
                                 f"equal {long_text == ref['long']}")
        b["handoff"] = {"decode_worker": dest[0],
                        "bytes": fm.scheduler.prefix_transfer_bytes,
                        "prefill_chunks": chunks}
        # SIGKILL of the decode worker the prompt routes to
        victim = {}

        def kill_routed(req, _submit=fm.scheduler.submit):
            if not victim:
                t, _ = fm.router.route(req.prompt)
                victim["r"], victim["pid"] = t, t.pid
                t.kill()
            return _submit(req)

        fm.scheduler.submit = kill_routed
        fail0 = fm.scheduler.failovers
        ftext = text(chat(url, bodies["failover"]))
        del fm.scheduler.submit
        rep = victim["r"]
        t_kill = time.monotonic()
        if ftext != ref["failover"] or fm.scheduler.failovers != fail0 + 1:
            raise AssertionError(f"worker fleet: failover text equal "
                                 f"{ftext == ref['failover']}, failovers "
                                 f"{fm.scheduler.failovers}")
        # (c) the remote worker, registered, served, killed, back, while
        # the killed decode worker respawns
        _wait_worker(port)
        reg = server.url + "/federated/register"
        wrong = _request(reg, key="not-the-token",
                         body={"address": f"127.0.0.1:{port}"})[0]
        t0 = time.monotonic()
        status, body = _request(reg, key=WORKER_TOKEN,
                                body={"address": f"127.0.0.1:{port}"})
        c["register_s"] = time.monotonic() - t0
        adopted = (body or {}).get("adopted", {}).get(name, {})
        if wrong != 401 or status != 200 or adopted.get("state") != \
                "healthy":
            raise AssertionError(f"worker remote: register {status} "
                                 f"{body}, wrong token {wrong}")
        rr = fm.pool.get(adopted["id"])
        rtext = complete(server.url)
        if rtext != ref["remote"] or rr.dispatched != 1:
            raise AssertionError(f"worker remote: text equal "
                                 f"{rtext == ref['remote']}, dispatched "
                                 f"{rr.dispatched}")
        remote.kill()
        remote.wait(30)
        fm.pool.note_failure(rr)
        if rr.state != "evicted" or fm.pool.evictions != 1:
            raise AssertionError(f"worker remote: state {rr.state} after "
                                 "SIGKILL")
        remote = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
        pids.add(remote.pid)
        _wait_worker(port)
        t0 = time.monotonic()
        while rr.state != "healthy" and time.monotonic() - t0 < 120:
            fm.pool.poll_once()
            time.sleep(0.2)
        c["rejoin_s"] = time.monotonic() - t0
        if rr.state != "healthy" or fm.pool.redials < 1 or rr.respawnable:
            raise AssertionError(f"worker remote: state {rr.state}, "
                                 f"redials {fm.pool.redials}")
        c.update({"address": f"127.0.0.1:{port}",
                  "evictions": fm.pool.evictions,
                  "redials": fm.pool.redials, "text": rtext})
        while rep.state != "healthy" and time.monotonic() - t_kill < 300:
            time.sleep(0.1)
        b["healthy_by_s"] = time.monotonic() - t_kill   # checked after (c)
        # the one respawn is the killed decode worker's: the remote was
        # redialed, never respawned
        if (rep.state != "healthy" or rep.pid == victim["pid"]
                or fm.pool.respawns != 1):
            raise AssertionError(f"worker fleet: the killed worker is "
                                 f"{rep.state}, pid {rep.pid}, respawns "
                                 f"{fm.pool.respawns}")
        pids.add(rep.pid)
        b["failover"] = {"killed": rep.id, "pid": victim["pid"],
                         "new_pid": rep.pid}
        b["card_used_peak_gb"] = _card_used_gb()
        server.shutdown()
        server = None
        # every decode worker stopped in order reported: K1 = L x steps
        reports = []
        for r in members:
            for i, report in enumerate(r.launch_reports):
                reports.append(_worker_report(f"{r.id} stop {i}", report,
                                              L, embeds=0))
        decode_steps = sum(rp["decode_steps"] for rp in reports)
        if len(reports) < 3 or decode_steps <= 0:
            raise AssertionError(f"worker fleet: {len(reports)} reports, "
                                 f"{decode_steps} decode steps")
        b["reports"] = reports
    finally:
        if server is not None:
            server.shutdown()
        if remote is not None and remote.poll() is None:
            remote.terminate()
            try:
                remote.wait(30)
            except subprocess.TimeoutExpired:
                remote.kill()
        _env(saved)
        gc.collect()
        torch.cuda.empty_cache()
    return b, c


def _wait_worker(port: int, timeout: float = 120.0) -> None:
    from localai_tpu_torch.worker.client import WorkerClient

    client = WorkerClient(f"127.0.0.1:{port}")
    try:
        deadline = time.monotonic() + timeout
        while not client.health(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"worker on port {port} never answered")
            time.sleep(0.2)
    finally:
        client.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    # no tuning table in HOME moves a serve's block size: the serves run
    # at the block sizes they name (phase_gallery_serve sets its own)
    os.environ["LOCALAI_TUNE_CACHE"] = "0"
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from localai_tpu_torch.ops import _build

    t_smoke = time.monotonic()
    card = nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    t0 = time.monotonic()
    _build.build_all()
    from localai_tpu_torch import native

    if native.load("fsm_walk") is None:
        raise AssertionError("the C trie walk (native/fsm_walk.c) did not "
                             "build")
    print(f"build: {time.monotonic() - t0:.1f}s ({', '.join(_build.SOURCES)}"
          f", fsm_walk)", flush=True)
    for src in _build.SOURCES:
        log = _build.build_log(src)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"ptxas {src}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, "
              f"{sum(int(x) > 0 for x in spills)} with spill stores",
              flush=True)
    k1 = phase_kernel()
    phase_autotune(card)
    attn = phase_attention()
    qmm = phase_qmatmul()
    phase_w8a8()
    experts = phase_moe_kernel(card)
    parity = phase_parity()
    phase_w8a8_selfextend_parity()
    phase_prompt_cache_parity()
    moe = phase_moe_parity()
    spec = phase_spec_parity()
    phase_frozen_parity()
    phase_templated_parity()
    phase_media()
    phase_vision_parity()
    llava_k = phase_kernel_llava()
    t_groups = time.monotonic()
    groups_k = phase_kernel_groups()
    group_parity = phase_group_parity()
    print(f"group phases: {time.monotonic() - t_groups:.1f}s", flush=True)
    phase_recurrent_parity()
    profile = "--profile" in sys.argv[1:]
    bf16 = phase_serve(card, profile=profile)
    served = {"": bf16["launches"],
              "contiguous": phase_serve(card, paged=False,
                                        profile=profile)["launches"]}
    for q in ("int8", "int4"):
        served[q] = phase_serve(card, q, profile=profile)["launches"]
    spec_serve = phase_serve(card, spec=True, profile=profile,
                             ref_texts=bf16["texts"])
    served["spec"] = spec_serve["launches"]
    served["w8a8"] = phase_serve_w8a8(card)
    phase_serve_selfextend(card)
    served["promptcache"] = phase_serve_prompt_cache(
        card, ref_texts=spec_serve["texts"])
    served["tools"] = phase_serve_tools(card)["launches"]
    served["templates"] = phase_serve_templates(card)["launches"]
    ckpt_root = _scratch_dir("checkpoint-parity-", 2_000_000_000)
    try:
        phase_checkpoint_parity(ckpt_root)
        phase_entry_point(card, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    # the checkpoint serve writes the Llama-3-8B checkpoint once; the
    # gallery serve installs it over HTTP and serves it from the table's
    # block size
    ckpt_root = Path(_scratch_dir("checkpoint-serve-", 13_000_000_000))
    try:
        served["checkpoint"] = phase_serve_checkpoint(
            card, root=ckpt_root)["launches"]
        gallery = phase_gallery_serve(
            card, ckpt_root / "Meta-Llama-3-8B-Instruct")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    served["gallery"] = gallery["launches"]
    phase_stores(card)
    tier = phase_kv_tier(card)
    fleet = phase_fleet(card)
    http = phase_http_surfaces(card)
    workers = phase_worker_tier(card)
    tp = phase_tensor_parallel(card)
    seq_pipe = phase_seq_pipe(card)
    t_qwen = time.monotonic()
    served["qwen"] = phase_serve_qwen(card)["launches"]
    print(f"group-7 serve: {time.monotonic() - t_qwen:.1f}s", flush=True)
    gguf = phase_gguf_convert(card)
    served["llava"] = phase_serve_llava(card)
    served["mixtral"] = phase_serve_mixtral(card, profile=profile)
    phase_serve_recurrent(card, "mamba")
    phase_serve_recurrent(card, "rwkv")
    phase_encoders(card)
    phase_audio(card)
    phase_image(card)
    src = "localai_tpu_torch/csrc/"
    k1_src = src + "paged_decode_attention.cu"
    k1_tpu = "localai_tpu/ops/attention.py:458"
    k2_src = src + "decode_attention.cu"
    k2_tpu = "localai_tpu/ops/attention.py:230"
    kernels = [
        _entry("paged_decode_attention", k1_src, k1_tpu,
               served[""]["paged_decode_attention"], k1["bf16"]),
        _entry("paged_decode_attention_f32", k1_src, k1_tpu,
               parity["paged-float32"]["paged_decode_attention"], k1["f32"]),
        _entry("paged_decode_attention_int8", k1_src, k1_tpu,
               served["int8"]["paged_decode_attention"], k1["int8"]),
        _entry("paged_decode_attention_int4", k1_src, k1_tpu,
               served["int4"]["paged_decode_attention"], k1["int4"]),
        _entry("w8_matmul", src + "w8_matmul.cu",
               "localai_tpu/ops/qmatmul.py:67",
               served["int8"]["w8_matmul"], qmm["w8"]["w_gate/w_up"]),
        _entry("w4_matmul", src + "w4_matmul.cu",
               "localai_tpu/ops/qmatmul.py:135",
               served["int4"]["w4_matmul"], qmm["w4"]["w_gate/w_up"]),
        _entry("decode_attention", k2_src, k2_tpu,
               served["contiguous"]["decode_attention"], attn["k2-bf16"]),
        _entry("decode_attention_f32", k2_src, k2_tpu,
               parity["contiguous-float32"]["decode_attention"],
               attn["k2-f32"]),
        _entry("decode_attention_int8", k2_src, k2_tpu,
               parity["contiguous-int8"]["decode_attention"],
               attn["k2-int8"]),
        # launches: fresh prefills of the contiguous server plus every
        # embedded input of the paged one
        _entry("prefill_attention", src + "prefill_attention.cu",
               "localai_tpu/ops/attention.py:337",
               served["contiguous"]["prefill_attention"]
               + served[""]["embedded_prefill_attention"],
               attn["k3-T2048-bf16"]),
        # the speculating bf16 server: K1 on its plain steps between
        # windows
        _entry("paged_decode_attention_spec", k1_src, k1_tpu,
               served["spec"]["paged_decode_attention"], k1["bf16"]),
        # the tools serve: constrained slots decode one token a dispatch
        # (step() or step_frozen_n), K1 once per layer per step
        _entry("paged_decode_attention_constrained", k1_src, k1_tpu,
               served["tools"]["paged_decode_attention"], k1["bf16"]),
        # the templated serve (two engines loaded from YAML): K1 once per
        # layer per decode step of both
        _entry("paged_decode_attention_templated", k1_src, k1_tpu,
               served["templates"]["paged_decode_attention"], k1["bf16"]),
        # the checkpoint serve (a Llama-3-8B checkpoint directory with its
        # tokenizer.json): K1 once per layer per decode step
        _entry("paged_decode_attention_checkpoint", k1_src, k1_tpu,
               served["checkpoint"]["paged_decode_attention"], k1["bf16"]),
        # int8_w8a8 weights over an int8 pool: K1 once per layer per plain
        # decode step (K4 never: the w8a8 products take torch._int_mm)
        _entry("paged_decode_attention_w8a8", k1_src, k1_tpu,
               served["w8a8"]["paged_decode_attention"], k1["int8"]),
        # the prompt-cache serve's five chats and, restarted on the same
        # directory, its two chats that hit the cache
        _entry("paged_decode_attention_promptcache", k1_src, k1_tpu,
               served["promptcache"]["paged_decode_attention"], k1["bf16"]),
        # verify windows (M = slots x 5 rows): launches inside the windows
        # of the spec parity phase, times at M = 40 (8 slots)
        _entry("w8_matmul_verify", src + "w8_matmul.cu",
               "localai_tpu/ops/qmatmul.py:67",
               spec["paged-int8"]["w8_matmul in windows"],
               qmm["w8-m40"]["w_gate/w_up"]),
        _entry("w4_matmul_verify", src + "w4_matmul.cu",
               "localai_tpu/ops/qmatmul.py:135",
               spec["paged-int4"]["w4_matmul in windows"],
               qmm["w4-m40"]["w_gate/w_up"]),
        # Mixtral-8x7B's expert products on K4's expert grid in the Mixtral
        # serve (decode steps, verify windows, prefill chunks): the gate and
        # up projections (x shared by every expert), times of one at M = 8;
        # the down projections (each expert its own rows). The JAX package
        # computes them as einsums outside Pallas (models/quant.py moe_up /
        # moe_down), which is what these entries name
        _entry("w8_matmul_experts", src + "w8_matmul.cu",
               "localai_tpu/models/quant.py:309",
               served["mixtral"]["w8_matmul_experts_up"], experts["up-m8"]),
        _entry("w8_matmul_experts_down", src + "w8_matmul.cu",
               "localai_tpu/models/quant.py:321",
               served["mixtral"]["w8_matmul_experts_down"],
               experts["down-m8"]),
        # f32 experts (the CUDA-core path): up projections of the
        # moe_parity phase's paged run; times of the f32 up projection at
        # Mixtral's widths, M = 8
        _entry("w8_matmul_experts_f32", src + "w8_matmul.cu",
               "localai_tpu/models/quant.py:309",
               moe["paged"]["w8_matmul_experts_up"], experts["up-m8-f32"]),
        # the dense projections and lm_head of the Mixtral serve (wq/wo's
        # 4096 x 4096 at M = 8 for times) and of the GGUF serve
        _entry("w8_matmul_mixtral", src + "w8_matmul.cu",
               "localai_tpu/ops/qmatmul.py:67",
               served["mixtral"]["w8_matmul"], qmm["w8"]["wq/wo"]),
        _entry("paged_decode_attention_mixtral", k1_src, k1_tpu,
               served["mixtral"]["paged_decode_attention"], k1["bf16"]),
        # the up projections of the served GGUF conversion (Mixtral's
        # widths, 2 layers)
        _entry("w8_matmul_experts_gguf", src + "w8_matmul.cu",
               "localai_tpu/models/quant.py:309",
               gguf["w8_matmul_experts_up"], experts["up-m8"]),
        # LLaVA-1.5-7B (Llama-2-7B: 32 query and 32 KV heads, a GQA group
        # of 1): K1 on the paged serve's decode steps, K2 and K3 on the
        # contiguous serve's image chats; times of the group-1 cases (K3
        # at the served shape, a 2048 bucket holding 640 rows)
        _entry("paged_decode_attention_llava", k1_src, k1_tpu,
               served["llava"]["paged"]["paged_decode_attention"],
               llava_k["k1"]),
        _entry("decode_attention_llava", k2_src, k2_tpu,
               served["llava"]["contiguous"]["decode_attention"],
               llava_k["k2"]),
        _entry("prefill_attention_llava", src + "prefill_attention.cu",
               "localai_tpu/ops/attention.py:337",
               served["llava"]["contiguous"]["prefill_attention"],
               llava_k["k3-served"]),
        # a GQA group of 7 (Qwen2.5-7B: 28 query / 4 kv heads): K1 on the
        # group-7 serve's decode steps, its int8 pool on the group-7
        # parity run's; K2 and K3 on that parity run's contiguous engine;
        # times at Qwen2.5-7B's heads (K3 at T = 2048)
        _entry("paged_decode_attention_group7", k1_src, k1_tpu,
               served["qwen"]["paged_decode_attention"], groups_k["k1"]),
        _entry("paged_decode_attention_int8_group7", k1_src, k1_tpu,
               group_parity["g7-paged-int8"]["paged_decode_attention"],
               groups_k["k1-int8"]),
        _entry("decode_attention_group7", k2_src, k2_tpu,
               group_parity["g7-contiguous-float32"]["decode_attention"],
               groups_k["k2"]),
        _entry("prefill_attention_group7", src + "prefill_attention.cu",
               "localai_tpu/ops/attention.py:337",
               group_parity["g7-contiguous-float32"]["prefill_attention"],
               groups_k["k3"]),
        # the gallery-installed Llama-3-8B, served at the tuning table's
        # block size of 32: K1 once per layer per decode step; times of
        # K1 at bt 32 (8 slots, contexts to 4096)
        _entry("paged_decode_attention_gallery", k1_src, k1_tpu,
               served["gallery"]["paged_decode_attention"],
               gallery["k1_bt32"]),
        # the host KV tier's serve (32 layers, bf16 at bt 64): K1 once per
        # layer per decode step, reloaded blocks included
        _entry("paged_decode_attention_kv_tier", k1_src, k1_tpu,
               tier["launches"]["paged_decode_attention"], k1["bf16"]),
        # the in-process fleets (SMOKE_LAYERS["fleet"] layers): K1 once per
        # layer per decode step of every replica engine of both servers
        _entry("paged_decode_attention_fleet", k1_src, k1_tpu,
               fleet["launches"] + fleet["e"]["launches"], k1["bf16"]),
        # the web UI's chat page (32 layers, bf16 at bt 64): K1 once per
        # layer per decode step of its streamed chat; the same chat
        # through the federation router, and again after a failover
        _entry("paged_decode_attention_ui", k1_src, k1_tpu,
               http["ui"]["launches"]["paged_decode_attention"],
               k1["bf16"]),
        _entry("paged_decode_attention_federation", k1_src, k1_tpu,
               http["federation"]["launches"]["paged_decode_attention"],
               k1["bf16"]),
        # the worker tier: K1 and K3 of the 32-layer worker processes,
        # from their own launch reports (K3 on their Embedding calls), and
        # K1 of the worker fleet's processes
        _entry("paged_decode_attention_worker", k1_src, k1_tpu,
               workers["launches"]["paged_decode_attention"], k1["bf16"]),
        _entry("prefill_attention_worker", src + "prefill_attention.cu",
               "localai_tpu/ops/attention.py:337",
               workers["launches"]["prefill_attention"],
               attn["k3-T2048-bf16"]),
        _entry("paged_decode_attention_worker_fleet", k1_src, k1_tpu,
               workers["fleet_launches"], k1["bf16"]),
        # tensor parallelism at model=2 (Llama-3-8B, both ranks on the
        # card): K1 on each rank's kv-head shard (16 q / 4 kv heads) over
        # the decode steps of both ranks, K3 on each rank's heads over the
        # embedded inputs and the logits prefill; times at that local shape
        _entry("paged_decode_attention_tp", k1_src, k1_tpu,
               tp["launches"]["paged_decode_attention"], tp["k1"]),
        _entry("prefill_attention_tp", src + "prefill_attention.cu",
               "localai_tpu/ops/attention.py:337",
               tp["launches"]["prefill_attention"], tp["k3"]),
        # sequence parallelism at seq=2 (Llama-3-8B, both ranks on the
        # card): K1 over the decode steps of both ranks (the ring prefill
        # itself launches no kernel); times at the served pool (4 slots,
        # MB 64)
        _entry("paged_decode_attention_sp", k1_src, k1_tpu,
               seq_pipe["launches"]["paged_decode_attention"],
               seq_pipe["k1"]),
        # pipeline parallelism at pipe=2: K2 on each stage's 16 layers a
        # decode step, K3 on each stage's 16 layers a fresh prefill or
        # logits prefill, both stages; times at the served shapes
        _entry("decode_attention_pp", k2_src, k2_tpu,
               seq_pipe["launches"]["decode_attention"], seq_pipe["k2"]),
        _entry("prefill_attention_pp", src + "prefill_attention.cu",
               "localai_tpu/ops/attention.py:337",
               seq_pipe["launches"]["prefill_attention"], seq_pipe["k3"]),
    ]
    print(f"smoke wall: {time.monotonic() - t_smoke:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0



def _phase_timer(fn):
    """``fn``, printing its wall time as it returns: every phase reports
    what it costs of the smoke's 1200 s."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            print(f"phase time {fn.__name__}: {time.monotonic() - t:.1f}s",
                  flush=True)
    return run


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _phase_timer(globals()[_name])


if __name__ == "__main__":
    sys.exit(main())
