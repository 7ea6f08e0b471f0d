#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --phases lm_tp_stacks,lm_serve_seq
                                     # the build, then those LM phases
                                     # and the ones they read (LM_NEEDS)

Builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc -c``
per source, all in parallel, linked into one library) and holds each
against its plain PyTorch version on the card:

* the chunk kernel, bit for bit, on all nine full circuits on the paper's
  15x15 grid at B=8 seeds, both the single and the batched binding, run to
  the end, and on random programs with mid-chunk exceptions, budgets,
  prologues and global memory;
* the seed kernel, bit for bit, on random programs (32-bit words, global
  memory) and on the first two Vcycles of each of the nine full circuits;
* flash attention against ``flash_ref`` (fp32 within 1e-4, bf16 within
  2e-2) at the reference kernel test's five shapes, GQA, a tail tile, a
  non-causal shape and the qwen3-0.6b, deepseek-moe-16b, zamba2-7b,
  whisper-medium (its encoder, not causal over 1500 frames, and its
  decoder, both at dh 64), qwen2-vl-72b (G 8) and starcoder2-3b (G 12,
  and one key tile of the same heads) prefills' (zamba2's
  shared attention: bf16 at dh 112) and a GQA tail case at dh 96, each on
  the kernel that ``flash_attention`` routes it to: bf16 (dh 64, or a
  multiple of 8 from 72 to 128, there on zero columns up to 128) on the
  wgmma kernel ``flash_attention_sm90.cu``, float32 (and bf16 at other
  head dims) on the 3xTF32 kernel ``flash_attention.cu``, there also
  saving lse
  (within 1e-5 of ``flash_ref``'s in fp32); each case's error against
  ``flash_ref`` in float64 beside it; the 3xTF32 split's rounding against
  ``cvt.rna.tf32.f32``;
* the backward flash kernel ``flash_attention_bwd.cu`` against
  ``flash_bwd_ref`` (each of dq, dk, dv within 1e-4 of its max in fp32,
  2e-2 in bf16) at the same cases, launched twice for the same bits,
  computing lse itself and, at the cases ``flash_attention.cu`` runs,
  given that kernel's lse (against ``flash_bwd_ref(lse=)``, with the error
  against ``flash_bwd_ref`` in float64 beside it); and at the bf16 cases
  the wgmma forward takes the wgmma backward kernel
  ``flash_attention_bwd_sm90.cu`` against ``flash_bwd_ref(lse=)`` with lse
  from the forward kernel (within 2e-2 of each output's max, the same bits
  on a relaunch).

Then it drives the paths, each through the calls a user makes, with the
launch counts set to 0 just before and read just after:

* the seed arm, ``repro_torch.sim.compile(name, scale="full")
  .run(engine="seed")`` on all nine circuits, equal to ``engine="machine"``
  and to the numpy ISA simulator;
* Fig 8 (global memory: FIFO vs RAM at 1/64/512 KiB) through ``machine``,
  ``seed`` and ``batched`` (B=64 seeds), equal to the ISA simulator;
* the main path ``repro_torch.sim.compile("mc", scale="full",
  seeds=range(512)).run()``;
* the multi-device engines on one and on four shards of the card:
  ``run(engine="sharded", devices=["cuda:0"] * 4)`` on the main path's
  512 seeds, and ``ShardedBatchedMachine`` (mc/full at B=512 and 510,
  bc/full at B=64) and ``GridMachine`` (mc/full and bc/full, one stimulus
  and 64) each bit-equal to ``BatchedMachine`` or ``Machine``;
* LM serving, ``repro_torch.launch.steps.make_serve_steps`` on qwen3-0.6b
  at full width (random weights from a seed): B=4 prompts of 2048 tokens,
  one prefill (28 ``flash_attention_sm90`` launches) and 32 greedy decode
  steps in bf16; in float32 the prefill (28 ``flash_attention_simt``
  launches) equals the same model on ``flash_ref`` and the first decode
  step equals a full forward over the 2049 tokens;
* MoE serving, ``make_serve_steps`` on deepseek-moe-16b at full width
  and all 28 layers (random weights from a seed): B=4 prompts of 2048
  tokens, one prefill (28 ``flash_attention_sm90`` launches, G = 1) and
  32 greedy decode steps in bf16, the init's peak bytes beside
  ``param_count`` x 2 and each prefill layer's dropped share; the index
  route equal to the reference's one-hot dispatch on layer 0's real
  input; float32 checks at two layers as for qwen3-0.6b (2
  ``flash_attention_simt`` launches a prefill; the decode check at
  capacity C = T); then mixtral-8x7b at 16 of its 32 layers, whose
  window (4096) covers its 2048-token prompts, so its prefill launches
  one ``flash_attention_sm90`` a layer, and 8 decode steps;
* SSM serving, ``make_serve_steps`` on zamba2-7b at full width and all 81
  layers (random weights from a seed): B=4 prompts of 2048 tokens, one
  prefill (13 ``flash_attention_sm90`` launches, one a group of six
  Mamba2 layers: its shared attention in bf16 at dh 112, causal, since
  its window of 4096 covers the prompt) and 16 greedy decode steps, one
  timed prefill and the decode loop again, the init's peak bytes beside
  ``param_count`` x 2; float32 checks at 9 layers as for qwen3-0.6b (1
  launch a prefill); then xlstm-125m whole (no attention, no kernel),
  32 decode steps and its float32 checks;
* encoder-decoder serving, ``make_serve_steps`` on whisper-medium at full
  width and all 48 layers (24 encoder, 24 decoder; random weights from a
  seed): B=4 prompts of 224 tokens over 1500 frames (a numpy seed), a
  cache for whisper's 448-token text context, one prefill (48
  ``flash_attention_sm90`` launches: the encoder's 24 not causal at BH
  64, S 1500, dh 64, the decoder's 24 causal at S 224) and 32 greedy
  decode steps (cross-attention on ``_sdpa``), 3 timed prefills and the
  decode loop again, prefill tokens/s beside encoder frames/s; float32
  checks at full depth as for qwen3-0.6b (48 launches a prefill);
* VLM serving, ``make_serve_steps`` on qwen2-vl-72b at full width and 24
  of its 80 layers: B=4 prompts of 256 patches (a numpy seed) and 2048
  tokens, a cache for 2336, one prefill (24 ``flash_attention_sm90``
  launches, causal, BH 256 over BHkv 32, S 2304, dh 128) and 8 decode
  steps from position 2304; float32 checks at 2 layers;
* LM training, ``repro_torch.launch.steps.make_train_step`` on qwen3-0.6b
  at full width in bf16 over ``TokenPipeline`` batches of 4 x 2048
  tokens: a warm-up step and three timed ones, each 56
  ``flash_attention_sm90`` launches (the forward, saving lse, and its
  recompute) and 28 ``flash_attention_bwd_sm90``, every leaf with a
  gradient; in float32 at two layers (on ``flash_attention_simt`` and
  ``flash_attention_bwd``) the step's gradients equal the same step on
  ``flash_ref`` under autograd, and 2 steps, a checkpoint, a restore and
  1 step equal 3 steps bit for bit;
* training the other stacks, ``make_train_step`` in bf16: whisper-medium
  whole (``lm_train_encdec``; 4 x 224 tokens over 1500 frames, a warm-up
  and three timed steps, each 96 ``flash_attention_sm90`` launches, the
  encoder's 48 not causal, and 48 ``flash_attention_bwd_sm90``), then
  xlstm-125m whole (no flash launch) and zamba2-7b at 9 of its 81 layers
  (``lm_train_ssm``; 4 x 2048 tokens, a warm-up and a timed step each;
  zamba2's shared attention 2 ``flash_attention_sm90`` and 1
  ``flash_attention_bwd_sm90`` launches a step), every leaf with a
  gradient,
  the peak beside a reckoning; in float32 at 2 + 2 layers (whisper) and
  9 (zamba2) the step's gradients on the 3xTF32 pair equal the same on
  ``flash_ref`` under autograd;
* the LM scaffold across devices, qwen3-0.6b at full width on a mesh of
  four shards of the card (``launch.mesh.make_host_mesh(devices=
  ["cuda:0"] * 4)``): ``lm_train_dp``, ``make_train_step(cfg, mesh)``
  data-parallel on ``lm_train``'s params and batches (each shard 1 x 2048
  tokens, one backward over the four losses, the bucketed gradient sum of
  ``distributed/overlap.py``, AdamW on every replica), 4 x 56
  ``flash_attention_sm90`` and 4 x 28 ``flash_attention_bwd_sm90``
  launches a step, the replicas bit-equal after every step, the first
  loss beside the one-device step's, the reduction's ms and the peak
  beside a reckoning; in float32 at two layers over two shards the step's
  loss, gradients and params equal the one-device step's; and
  ``lm_serve_dp``, ``make_serve_steps(cfg, mesh)``, B=4 prompts of 2048
  tokens a shard each (4 x 28 launches a prefill) and 32 greedy steps,
  in float32 at two layers over two shards the logits and greedy tokens
  of the one-device serve;
* tensor parallelism on mesh (1, 4) of the card: ``lm_train_tp``
  (qwen3-0.6b trained, 4 query and 2 KV heads a shard), ``lm_serve_tp``
  (deepseek-moe-16b served expert-parallel, with the share of MoE routes
  it picks otherwise than ``lm_serve_moe``'s prefill and its logits with
  those routes forced), ``lm_tp_stacks`` (zamba2-7b at 9 layers and
  xlstm-125m whole on 4 x 512 tokens, whisper-medium whole on 4 x 224
  over 1500 frames, each trained a warm-up and a timed step and served a
  prefill and 8 greedy steps, each shard on its heads or channels, the
  flash launches counted; float32 train and serve checks, the
  one-device and the tensor-parallel run each against the same
  function evaluated in float64, and the float64 runs against each
  other at the CPU tests' tolerances) and ``lm_serve_seq`` (qwen3-0.6b served under
  ``REPRO_KV_SHARD=seq``: each shard every KV head of a quarter of the
  slots, the decode's partial softmaxes joined on shard 0; float32 at
  two layers with every cache block checked);
* the configs no earlier phase runs, at full width and depth in bf16
  (``lm_configs``): starcoder2-3b (GELU MLP, QKV bias, 24 query heads
  over 2 KV heads, G 12) and qwen3-1.7b (qk-norm), each served (a
  prefill of one ``flash_attention_sm90`` launch a layer, 8 greedy
  steps) and trained (a warm-up and a timed step of 4 x 2048 tokens, 2L
  ``flash_attention_sm90`` and L ``flash_attention_bwd_sm90`` launches),
  with float32 serve and train checks at two layers;
* a model past one card (``lm_serve_big``): qwen1.5-110b at full width
  and 20 of its 80 layers served over four model shards of the card
  (mesh (1, 4)), its parameters drawn straight into their blocks
  (``sharding.init_sharded``), 4 x 20 ``flash_attention_sm90`` launches
  a prefill at a shard's 16 query and 2 KV heads and 8 greedy steps, the
  init's seconds and each device's peak beside a reckoning, float32 at
  two layers on the same mesh against one device
  (``scripts/multi_card.py --serve-big``: qwen1.5-110b, qwen2-vl-72b and
  mixtral-8x7b whole, one model shard a card);
* the dry run (``dryrun``, ``launch/dryrun.py``): qwen3-0.6b whole, a
  prefill of 1 x 32768 tokens and a train step of 2 x 4096 planned on
  meta tensors and then run, planned FLOPs, flash launches and peak held
  to the card's, loss and gradient norm finite; the flash forward at S
  32768 against ``flash_ref`` row by row, and a planted fault that check
  must fail; four cells of the 16x16 mesh and the six ``long_500k``
  cells (a batch of 1, replicated over the data axis) of both
  production meshes planned in worker processes, each of which must
  plan, the runs timed after the workers end;

and times each kernel against its bound (both flash kernels, the wgmma
one also saving lse, the plain version and SDPA in turns at the
prefill's shape in bf16, the wgmma kernel at zamba2-7b's prefill shape
(dh 112 on zero columns up to 128, the SSM serving path's) beside the
3xTF32 kernel that ran it before, and the wgmma kernel at
whisper-medium's encoder shape and qwen2-vl-72b's prefill shape, each
against the plain version and SDPA in turns, the 3xTF32 kernel with and
without lse, the plain version and SDPA in turns in float32, and in bf16
both backward kernels, the plain version and SDPA's backward in turns,
in float32 the 3xTF32 one with and without lse, and the backward
kernels at the new training shapes, the wgmma one not causal at
whisper's encoder and at zamba2's dh 112 (beside the 3xTF32 one that
ran it before), and
the wgmma pair at starcoder2-3b's G 12 and the forward at a
qwen1.5-110b model shard's heads; the float32 rows give the fp32
CUDA-core bound and the 3xTF32 tensor-core bound). Each Vcycle
case of the timing also reports what bounds the kernel: the
busiest core's rows a Vcycle (``busy_rows``), the kernel's ns per such row
(``ns_per_busy_row``), the bytes of code rows it reads a launch
(``code_bytes``) and, for the chunk kernel, its shared memory a block,
blocks an SM and waves. Each phase prints one JSON line;
the last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
such line, when any phase fails, when no CUDA device is present, or when
run outside a checkout.
"""
import asyncio
import concurrent.futures as cf
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing as mp
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

NAMES = ("bc", "blur", "cgra", "jpeg", "mc", "mm", "noc", "rv32r", "vta")
CHECK_SEEDS = 8
MAIN_SCALE = "full"
MAIN_SEEDS = 512
MAIN_FINISH = 130          # mc/full raises FINISH at cycle n_cycles + 2
FIG8_N = 2048              # benchmarks/fig8_global_stall.py
FIG8_SEEDS = 64
FIG8_KIB = (1, 64, 512)
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LM_CTX = LM_PROMPT + 64
LM_GREEDY_CHECK = 8        # greedy tokens compared in float32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak
# INT32 issue rate: the H100 SXM's 67 TFLOP/s FP32 peak is 132 SMs x 128
# lanes x 2 (FMA) x 1.98 GHz; each SM has 64 INT32 lanes, one op per clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9


T_IMPORT = time.perf_counter()


def emit(obj) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``at_s``)."""
    print(json.dumps({**obj, "at_s": time.perf_counter() - T_IMPORT}),
          flush=True)


def compile_full(name: str, n_seeds: int):
    """Worker: build and compile one full circuit on the default 15x15 grid
    with ``n_seeds`` stimuli (host-only numpy work)."""
    from repro_torch.circuits import build
    from repro_torch.core.compile import compile_circuit
    from repro_torch.core.isa import HardwareConfig
    t0 = time.perf_counter()
    b = build(name, "full", seeds=range(n_seeds))
    prog = compile_circuit(b.circuit, HardwareConfig())
    images = b.images_batch(prog)
    return name, b.n_cycles, prog, images, time.perf_counter() - t0


# ------------------------------------------------------------ phases ----
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def timed_build(kbuild):
    t0 = time.perf_counter()
    path, log = kbuild.build()
    return path, log, time.perf_counter() - t0


# each kernel's name in the compiler's report: the first key that its
# mangled entry function holds
PTXAS_KERNELS = {"flash_attention_bwd_sm90_delta_kernel":
                 "flash_attention_bwd_sm90",
                 "flash_attention_bwd_sm90_dkdv_kernel":
                 "flash_attention_bwd_sm90",
                 "flash_attention_bwd_sm90_dq_kernel":
                 "flash_attention_bwd_sm90",
                 "vcycle_chunk_kernel": "vcycle_chunk",
                 "vcycle_seed_kernel": "vcycle_seed",
                 "flash_attention_sm90_kernel": "flash_attention_sm90",
                 "flash_attention_kernel": "flash_attention_simt",
                 "tf32x3_rounding_kernel": "tf32x3_rounding",
                 "flash_attention_bwd_delta_kernel": "flash_attention_bwd",
                 "flash_attention_bwd_dkdv_kernel": "flash_attention_bwd",
                 "flash_attention_bwd_dq_kernel": "flash_attention_bwd"}


def phase_build(kbuild, build_future):
    """The library every kernel is built into, with each kernel's
    registers a thread, static shared memory and spills from the
    compiler's -Xptxas -v report (the most over a kernel's template
    instances), and the flash kernels' dynamic shared memory (and, for the
    3xTF32 ones in float32, blocks an SM). Those kernels (each backward
    kernel's three entry functions counted as one) and the two Vcycle
    kernels must not spill."""
    t0 = time.perf_counter()
    path, log, build_s = build_future.result()
    ptxas, kernel = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            kernel = next((name for key, name in PTXAS_KERNELS.items()
                           if key in m.group(1)), m.group(1))
            ptxas.setdefault(kernel, {"registers": 0, "smem_bytes": 0,
                                      "spill_bytes": 0})
        if kernel is None:
            continue
        info = ptxas[kernel]
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("spill_bytes", r"(\d+) bytes spill stores")):
            m = re.search(pat, ln)
            if m:
                info[key] = max(info[key], int(m.group(1)))
        m = re.search(r"(\d+) bytes spill loads", ln)
        if m:
            info["spill_bytes"] = max(info["spill_bytes"], int(m.group(1)))
    lib = kbuild.load()
    if "flash_attention_sm90" in ptxas:
        ptxas["flash_attention_sm90"]["dynamic_smem_bytes"] = {
            dh: lib.flash_attention_sm90_smem_bytes(dh)
            for dh in (64, 112, 128)}
    if "flash_attention_bwd_sm90" in ptxas:
        ptxas["flash_attention_bwd_sm90"]["dynamic_smem_bytes"] = {
            dh: {"dkdv": lib.flash_attention_bwd_sm90_smem_bytes(dh, 0),
                 "dq": lib.flash_attention_bwd_sm90_smem_bytes(dh, 1)}
            for dh in (64, 112, 128)}
    for name, smem, blocks in (
            ("flash_attention_simt",
             lambda dh, bf: lib.flash_attention_smem_bytes(dh, bf),
             lambda dh: {"fwd": lib.flash_attention_blocks_per_sm(dh)}),
            ("flash_attention_bwd",
             lambda dh, bf: {"dkdv": lib.flash_attention_bwd_smem_bytes(
                 0, dh, bf), "dq": lib.flash_attention_bwd_smem_bytes(
                     1, dh, bf)},
             lambda dh: {"dkdv": lib.flash_attention_bwd_blocks_per_sm(0, dh),
                         "dq": lib.flash_attention_bwd_blocks_per_sm(1, dh)})):
        if name in ptxas:
            ptxas[name]["dynamic_smem_bytes"] = {
                f"{dt}_dh{dh}": smem(dh, int(dt == "bf16"))
                for dt in ("fp32", "bf16") for dh in (32, 64, 128)}
            ptxas[name]["fp32_blocks_per_sm"] = {
                dh: blocks(dh) for dh in (32, 64, 128)}
    # the compiler's notes on the warp-specialised kernels: a setmaxnreg it
    # ignored, or wgmma issues it serialized
    wgmma_notes = [ln.strip() for ln in log.splitlines()
                   if "setmaxnreg" in ln or "serialized" in ln]
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "registers_per_thread": {k: v["registers"]
                                   for k, v in ptxas.items()},
          "ptxas": ptxas, "ptxas_warnings": [
              ln.strip() for ln in log.splitlines() if "arning" in ln],
          "ptxas_wgmma_notes": wgmma_notes,
          "build_s": build_s, "waited_s": time.perf_counter() - t0})
    for name in ("flash_attention_sm90", "flash_attention_simt",
                 "flash_attention_bwd", "flash_attention_bwd_sm90",
                 "vcycle_chunk", "vcycle_seed"):
        info = ptxas.get(name)
        if info is None or info["spill_bytes"]:
            raise AssertionError(f"{name}: not built or spills ({info})")
    ignored = [ln for ln in wgmma_notes if "setmaxnreg" in ln]
    if ignored:
        raise AssertionError(f"the compiler ignored setmaxnreg: {ignored}")


def _same(a, b) -> int:
    """Max |a - b| over int32 tensors (0 iff bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


OUTPUTS = ("regs", "spads", "flags", "nexec", "gmem", "tags", "counters")
SEED_OUTPUTS = ("regs", "spads", "flags", "trace", "gmem", "tags",
                "counters")


def check_chunk(kv, args, budget, kw, tag, layout=None, rows=None):
    """One chunk through the kernel and the plain version on the same
    inputs; returns the kernel's outputs after asserting bit equality."""
    out_k = kv.vcycle_chunk(*args, budget, layout=layout, rows=rows, **kw)
    out_p = kv.vcycle_chunk_ref(*args, budget, **kw)
    if len(out_k) != len(out_p):
        raise AssertionError(f"{tag}: {len(out_k)} outputs != "
                             f"{len(out_p)}")
    for name, a, b in zip(OUTPUTS, out_k, out_p):
        err = _same(a, b)
        if err:
            raise AssertionError(f"{tag}: kernel != plain in {name} "
                                 f"(max abs err {err})")
    return out_k


def phase_circuit(torch, kv, bsp, IsaSim, item):
    """Kernel vs plain, chunk by chunk to the end, for one full circuit:
    batched binding on all elements, single binding on element 0, and the
    prologue-only launch at init."""
    name, n_cycles, prog, images, compile_s = item
    cells = set(zip(prog.xchg_dst_core.tolist(), prog.xchg_dst_reg.tolist()))
    if len(cells) != prog.n_sends:
        raise AssertionError(f"{name}: two exchange entries share a "
                             "destination register")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bm = bsp.BatchedMachine(prog, images=images, device=dev)
    sm = bsp.Machine(prog, device=dev)
    kb, ks = bm._kernel, sm._kernel
    C, R = bm.C, bm.R
    raw = bsp.to_words(np.asarray(images[0])[:, :C, :R], dev)
    if kb.num_pro:
        pro = kv.prologue_ref(kb.code, kb.luts, raw, bm.bspad0,
                              num_pro=kb.num_pro)
        if _same(pro, bm.breg0):
            raise AssertionError(f"{name}: prologue kernel != plain")
    st = bm.init_state()
    regs, spads, flags = st.regs, st.spads, st.flags
    cyc = torch.zeros((bm.B,), dtype=torch.int32, device=dev)
    budget = n_cycles + 10
    kw = dict(K=kb.K, n_sends=kb.n_sends, num_pro=kb.num_pro)
    chunks = 0
    while True:
        args = (*kb.tables(), regs, spads, flags, cyc)
        regs2, spads2, flags2, nexec = check_chunk(
            kv, args, budget, kw, f"{name} chunk {chunks}", kb.layout,
            kb.rows)
        carry0 = tuple(x[0] for x in (regs, spads, st.gmem, flags,
                                      st.cache_tags, st.counters))
        cyc1, out1 = ks(cyc[:1].clone(), budget, carry0)
        for nm, a, b in (("regs", out1[0], regs2[0]),
                         ("spads", out1[1], spads2[0]),
                         ("flags", out1[3], flags2[0]),
                         ("cyc", cyc1, cyc[:1] + nexec[:1])):
            if _same(a, b):
                raise AssertionError(f"{name}: single binding != batched "
                                     f"in {nm}")
        regs, spads, flags, cyc = regs2, spads2, flags2, cyc + nexec
        chunks += 1
        if bool(flags.ne(0).any(1).all()) or int(cyc.min()) >= budget:
            break
    exc = [sorted(set(int(e) for e in row if e))
           for row in bsp.from_words(flags)]
    cycles = cyc.tolist()
    if any(e != [1] for e in exc) or any(c != n_cycles for c in cycles):
        raise AssertionError(f"{name}: not all FINISH at {n_cycles}: "
                             f"{exc} {cycles}")
    # element 0's images as the program's own init: IsaSim then applies
    # iteration 0's prologue to them itself
    isa = IsaSim(dataclasses.replace(prog, reg_init=images[0][0],
                                     spad_init=images[1][0]))
    isa.run(budget)
    if not np.array_equal(isa.regs, bsp.from_words(regs[0])):
        raise AssertionError(f"{name}: element 0 != IsaSim")
    S = int(prog.spad_init.shape[1])
    emit({"phase": "kernel_vs_plain", "circuit": name, "B": bm.B, "C": C,
          "T": int(prog.code.shape[1]), "R": R, "S": S,
          "state_kb_dense": 4 * C * (R + S) / 1024,
          "state_kb_packed": 4 * (kb.layout.words + C * S) / 1024,
          "n_sends": kb.n_sends,
          "prologue": kb.num_pro, "finish_cycle": n_cycles,
          "chunks": chunks, "max_abs_err": 0, "compile_s": compile_s,
          "check_s": time.perf_counter() - t0})


def phase_random(torch, kv, random_chunk, CacheModel):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2023)
    cases = []
    K = 16
    C, T, R, S, L, n_sends = 90, 48, 40, 24, 32, 40
    for B, num_pro, budget, G in ((1, 0, 1000, 0), (8, 0, 20, 0),
                                  (8, 4, 1000, 0), (3, 6, 9, 0),
                                  (8, 2, 1000, 5000)):
        arrays = random_chunk(rng, rng.choice([3, 7, 11, 100], B), C, T, R,
                              S, L, n_sends, num_pro,
                              Cp=((C + 31) // 32) * 32, G=G)
        arrays = [torch.from_numpy(a).to(dev) for a in arrays]
        args = tuple(arrays[:7]) + (
            torch.zeros((B, C), dtype=torch.int32, device=dev),
            torch.from_numpy(rng.integers(0, 8, B).astype(np.int32)).to(dev))
        kw = dict(K=K, n_sends=n_sends, num_pro=num_pro)
        if G:
            kw.update(gmem=arrays[7], tags=arrays[8], counters=arrays[9],
                      cache=CacheModel(32, 14, 120))
        out = check_chunk(kv, args, budget, kw,
                          f"random B={B} pro={num_pro} G={G}")
        flags, nexec = out[2], out[3]
        cases.append({"B": B, "num_pro": num_pro, "budget": budget,
                      "G": G, "nexec": nexec.tolist(),
                      "raised": flags.ne(0).any(1).tolist()})
    mid = [n for c in cases for n, r in zip(c["nexec"], c["raised"])
           if r and 0 < n < K]
    if not mid:
        raise AssertionError("no random program froze mid-chunk")
    emit({"phase": "random_programs", "cases": cases, "max_abs_err": 0})


def check_seed(kv, args, glob, tag, **kw):
    """One Vcycle through the seed kernel and its plain version on the same
    inputs; returns the kernel's outputs after asserting bit equality."""
    out_k = kv.vcycle_seed(*args, *glob, **kw)
    kw.pop("gcore", None)
    kw.pop("tables", None)
    out_p = kv.vcycle_seed_ref(*args, *glob, **kw)
    if len(out_k) != len(out_p):
        raise AssertionError(f"{tag}: {len(out_k)} outputs != "
                             f"{len(out_p)}")
    for name, a, b in zip(SEED_OUTPUTS, out_k, out_p):
        err = _same(a, b)
        if err:
            raise AssertionError(f"{tag}: seed kernel != plain in {name} "
                                 f"(max abs err {err})")
    return out_k


def phase_seed_random(torch, kv, random_vcycle, CacheModel):
    """The seed kernel on random programs: the five (C, T, R, S) shapes of
    tests/test_kernels.py, a full-width one, and three with GLD/GST on one
    core; 32-bit words throughout, so the masked register write shows."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    cache = CacheModel(32, 14, 120)
    cases = []
    for C, T, R, S, G in ((1, 4, 8, 16, 0), (4, 16, 32, 64, 0),
                          (8, 32, 64, 32, 0), (16, 8, 16, 16, 0),
                          (6, 12, 24, 48, 0), (225, 137, 143, 4, 0),
                          (1, 29, 22, 5, 4096), (4, 64, 24, 8, 100),
                          (130, 64, 40, 4, 262144)):
        arrays = [torch.from_numpy(a).to(dev) for a in random_vcycle(
            rng, C, T, R, S, 32, G, 2048 if G > 4096 else 8, gcore=C - 1,
            Cp=((C + 31) // 32) * 32)]
        out = check_seed(kv, arrays[:5], arrays[5:], f"random C={C} T={T}",
                         cache=cache)
        cases.append({"C": C, "T": T, "R": R, "S": S, "G": G,
                      "raised": int(out[2].ne(0).sum())})
    emit({"phase": "seed_vs_plain", "programs": "random", "cases": cases,
          "max_abs_err": 0})


def check_seed_circuit(torch, kv, bsp, item):
    """The first two seed Vcycles of one full circuit (element 0 of its
    seeded build), kernel against plain, the exchange applied between."""
    name, _, prog, images, _ = item
    m = bsp.Machine(prog, device=torch.device("cuda"), specialize=False)
    carry = tuple(m.init_state(tuple(a[0] for a in images)))
    b = m._seed
    for v in range(2):
        regs, spads, gmem, flags, tags, counters = carry
        glob = (gmem, tags, counters) if b.gcore >= 0 else ()
        check_seed(kv, (b.code, b.luts, regs, spads, flags), glob,
                   f"{name} Vcycle {v}", cache=b.cache, gcore=b.gcore,
                   tables=b.tables)
        carry = m._vcycle_seed(carry)
    emit({"phase": "seed_vs_plain", "circuit": name, "C": m.C,
          "T": int(prog.code.shape[1]), "R": m.R,
          "prologue_rows": int(prog.pipe_prologue), "vcycles": 2,
          "max_abs_err": 0})


def _result_key(r, perf=True):
    key = (r.cycles, r.exceptions, r.registers, r.outputs)
    return key + (r.perf,) if perf else key


def _vcycles_per_s(torch, eng, n):
    """Simulated Vcycles/s of one engine run: host clock around work that
    ends in a synchronize."""
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = eng.run(n)
    torch.cuda.synchronize()
    return r.cycles / (time.perf_counter() - t0)


def phase_seed_arm(torch, kv, sim, name):
    """This slice's path at full width: one circuit through
    ``run(engine="seed")``, counted, against ``run(engine="machine")`` and
    the numpy ISA simulator."""
    t0 = time.perf_counter()
    s = sim.compile(name, scale="full")
    compile_s = time.perf_counter() - t0
    kv.reset_counts()
    seed = s.run(engine="seed")
    torch.cuda.synchronize()
    counts = dict(kv.COUNTS)
    if counts["vcycle_seed"] <= 0 or counts["vcycle_chunk"]:
        raise AssertionError(f"{name}: the seed path launched {counts}")
    kv.reset_counts()
    machine = s.run(engine="machine")
    torch.cuda.synchronize()
    machine_counts = dict(kv.COUNTS)
    if machine_counts["vcycle_chunk"] <= 0 or machine_counts["vcycle_seed"]:
        raise AssertionError(f"{name}: the machine path launched "
                             f"{machine_counts}")
    isa = s.run(engine="isa")
    if not seed.finished or _result_key(seed) != _result_key(machine):
        raise AssertionError(f"{name}: seed arm != machine")
    if _result_key(seed, False) != _result_key(isa, False):
        raise AssertionError(f"{name}: seed arm != IsaSim")
    n = s.default_cycles()
    rates = {k: _vcycles_per_s(torch, s.engine(k), n)
             for k in ("seed", "machine")}
    emit({"phase": "seed_arm", "circuit": name,
          "call": f"repro_torch.sim.compile('{name}', scale='full')"
                  ".run(engine='seed')",
          "C": s.program.used_cores, "T": int(s.program.code.shape[1]),
          "R": s.program.used_reg_count(), "finish_cycle": seed.cycles,
          "equal_to": ["machine", "isa"], "launches": counts,
          "machine_launches": machine_counts,
          "seed_vcycles_per_s": rates["seed"],
          "machine_vcycles_per_s": rates["machine"],
          "compile_s": compile_s})
    return s, counts["vcycle_seed"], machine_counts["vcycle_chunk"]


def _isa_check(IsaEngine, s, images, n, runs, tag):
    """Registers and global memory of one stimulus against IsaSim;
    ``runs`` maps an engine's name to its (registers, gmem)."""
    isa = IsaEngine(s.program, images=images)
    r = isa.run(n)
    for name, (regs, gmem) in runs.items():
        if r.registers != regs:
            raise AssertionError(f"{tag} {name}: registers != IsaSim")
        if not np.array_equal(isa.sim.gmem, gmem):
            raise AssertionError(f"{tag} {name}: gmem != IsaSim")


def phase_fig8(torch, kv, sim, bsp, IsaEngine, build_membench, hw, cache_cls):
    """Fig 8 on the card: FIFO vs RAM at 1/64/512 KiB through ``machine``,
    ``seed`` and ``batched`` (B=64 seeds), counted; registers and gmem
    equal IsaSim, ``perf()`` identical across the engines, and the chunk
    kernel equal to its plain version on the first two chunks of each
    global config. Prints machine cycles normalised to 1 KiB and the hit
    rate (benchmarks/fig8_global_stall.py's numbers)."""
    rows, batched = [], {}
    for kind in ("fifo", "ram"):
        base = None
        for kib in FIG8_KIB:
            tag = f"{kind}/{kib}KiB"
            s = sim.compile(build_membench(kind, kib, n_cycles=FIG8_N), hw)
            sb = sim.compile(build_membench(kind, kib, n_cycles=FIG8_N,
                                            seeds=range(FIG8_SEEDS)), hw)
            n = s.default_cycles()
            kv.reset_counts()
            engines = {k: s.engine(k) for k in ("machine", "seed")}
            res = {k: e.run(n) for k, e in engines.items()}
            bat = sb.engine("batched")
            res_b = bat.run_batch(n)
            e0 = {k: sb.engine(k) for k in ("machine", "seed")}
            res0 = {k: e.run(n) for k, e in e0.items()}
            torch.cuda.synchronize()
            counts = dict(kv.COUNTS)
            if min(counts.values()) <= 0:
                raise AssertionError(f"{tag}: launches {counts}")
            if (res["machine"].cycles != FIG8_N + 1
                    or not all(r.finished for r in res_b)):
                raise AssertionError(f"{tag}: not FINISHed at {FIG8_N + 1}")
            if _result_key(res["machine"]) != _result_key(res["seed"]):
                raise AssertionError(f"{tag}: seed != machine")
            if not (_result_key(res0["machine"]) == _result_key(res0["seed"])
                    == _result_key(res_b[0])):
                raise AssertionError(f"{tag}: seed 0 differs across engines")
            _isa_check(IsaEngine, s, None, n, {
                k: (res[k].registers, bsp.from_words(e.state.gmem))
                for k, e in engines.items()}, tag)
            _isa_check(IsaEngine, sb, tuple(a[0] for a in
                                            sb.images_stacked()), n,
                       {"batched": (res_b[0].registers,
                                    bsp.from_words(bat.state.gmem[0]))},
                       tag)
            chunks = 0
            if s.program.has_global:
                chunks = check_fig8_chunks(torch, kv, bat, n, tag)
            batched[(kind, kib)] = bat
            perf = res["machine"].perf
            cyc = perf["machine_cycles"]
            base = cyc if base is None else base
            acc = perf["ghits"] + perf["gmisses"]
            rows.append({
                "kind": kind, "kib": kib, "global": s.program.has_global,
                "machine_cycles": cyc, "normalized": cyc / base,
                "hit_rate": perf["ghits"] / acc if acc else 1.0,
                "ghits": perf["ghits"], "gmisses": perf["gmisses"],
                "stall_cycles": perf["stall_cycles"],
                "batched_machine_cycles": bat.perf()["machine_cycles"],
                "launches": counts, "chunks_vs_plain": chunks})
    emit({"phase": "fig8", "n_cycles": FIG8_N, "B": FIG8_SEEDS,
          "engines": ["machine", "seed", "batched"],
          "equal_to": "IsaSim (registers, gmem); perf across engines",
          "rows": rows})
    return batched[("ram", 512)]


def check_fig8_chunks(torch, kv, bat, n, tag):
    """The batched binding's first two chunks, kernel against plain,
    global memory and counters included."""
    k = bat.m._kernel
    st = bat.m.init_state()
    regs, spads, gmem, flags, tags, counters = st
    cyc = torch.zeros((bat.m.B,), dtype=torch.int32, device=regs.device)
    kw = dict(K=k.K, n_sends=k.n_sends, num_pro=k.num_pro, cache=k.cache)
    for c in range(2):
        args = (*k.tables(), regs, spads, flags, cyc)
        out = check_chunk(kv, args, n, dict(kw, gmem=gmem, tags=tags,
                                            counters=counters),
                          f"{tag} chunk {c}", k.layout, k.rows)
        regs, spads, flags, nexec, gmem, tags, counters = out
        cyc = cyc + nexec
    return 2


def phase_main(torch, kv, sim, IsaEngine):
    """The user's call at full width, counted and checked."""
    t0 = time.perf_counter()
    s = sim.compile("mc", scale=MAIN_SCALE, seeds=range(MAIN_SEEDS))
    compile_s = time.perf_counter() - t0
    kv.reset_counts()
    t0 = time.perf_counter()
    results = s.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kv.COUNTS["vcycle_chunk"]
    if launches <= 0:
        raise AssertionError("main path launched no vcycle_chunk kernel")
    if len(results) != MAIN_SEEDS:
        raise AssertionError(f"{len(results)} results, not {MAIN_SEEDS}")
    bad = [r.batch_index for r in results
           if not r.finished or r.cycles != MAIN_FINISH]
    if bad:
        raise AssertionError(f"elements not FINISHed at {MAIN_FINISH}: "
                             f"{bad[:10]}")
    t0 = time.perf_counter()
    stacked = s.images_stacked()
    images_s = time.perf_counter() - t0
    for i in range(4):
        ref = IsaEngine(s.program, images=tuple(a[i] for a in stacked)) \
            .run(s.default_cycles())
        r = results[i]
        if (ref.cycles, ref.exceptions, ref.registers) != \
                (r.cycles, r.exceptions, r.registers):
            raise AssertionError(f"element {i} != IsaSim")
    # aggregate simulated Vcycles/s: the engine alone, host clock around
    # work that ends in a synchronize
    eng = s.engine()
    rates = []
    for _ in range(3):
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.m.run(eng.state, s.default_cycles())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(eng.m.perf(st)["vcycles"] / dt)
    # the same run plus the per-element RunResult snapshots
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_batch(s.default_cycles())
    run_batch_s = time.perf_counter() - t0
    emit({"phase": "main_path", "call": "repro_torch.sim.compile('mc', "
          f"scale='{MAIN_SCALE}', seeds=range({MAIN_SEEDS})).run()",
          "B": MAIN_SEEDS,
          "all_finished_at": MAIN_FINISH, "isasim_checked": 4,
          "launches": launches, "compile_s": compile_s, "run_s": run_s,
          "images_s": images_s, "run_batch_s": run_batch_s,
          "vcycles_per_s": rates, "C": eng.m.C, "R": eng.m.R,
          "T": int(s.program.code.shape[1])})
    return eng, launches, s, results

# the serving path (benchmarks/bench_serve.py's three modes, at full scale
# on the default 15x15 grid): mixed mc+bc traffic, 64 requests a circuit
SERVE_NAMES = ("mc", "bc")
SERVE_SCALE = "full"
SERVE_PER_CIRCUIT = 64
SERVE_WAIT_S = 0.03
SERVE_MODES = ("coalesced", "b1", "hardened")
SERVE_ISA_SEEDS = 4
CHAOS_N = 100
# elastic migrations (examples/simulate_accelerator.py): (circuit, the
# small grid's side), each moved half way to the default 15x15 grid; bc is
# modulo-pipelined on both grids, so its prologue runs on the carried state
ELASTIC_CASES = (("rv32r", 5), ("mc", 3), ("bc", 5))


def _serve_reqs(serve, seed0: int):
    """Interleaved mc, bc, mc, ... requests on seeds seed0, seed0 + 1, ..."""
    return [serve.SimRequest(nm, scale=SERVE_SCALE, seed=seed0 + i)
            for i in range(SERVE_PER_CIRCUIT) for nm in SERVE_NAMES]


async def _serve_wave(server, reqs):
    """Every request at once; per-request latency and the wave's wall."""
    lat = {}

    async def one(r):
        t0 = time.perf_counter()
        resp = await server.submit(r)
        lat[r.rid] = time.perf_counter() - t0
        return resp

    t0 = time.perf_counter()
    resps = await asyncio.gather(*(one(r) for r in reqs))
    return resps, time.perf_counter() - t0, [lat[r.rid] for r in reqs]


def _served_ok(resps, tag):
    bad = [r for r in resps if not (r.ok and r.result.finished)]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} requests not OK/finished "
                             f"(first: {bad[0].status} {bad[0].error})")


def _stages(before, after) -> dict:
    """Where a wave's launches spent their time, as the daemon timed them
    (``SimServer.stats()["stages"]``): seconds per launch, and the engines
    built for a new batch size instead of rebinding a hot one."""
    n = after["launches"] - before["launches"]
    out = {k: (after[k] - before[k]) / n for k in
           ("images_s", "engine_s", "chunks_s", "snapshots_s")}
    out["launches"] = n
    out["engines_built"] = after["engines_built"] - before["engines_built"]
    return out


async def _serve_mode(torch, kv, serve, mode, cache_dir, device):
    """One of bench_serve.py's modes: a warm-up wave, then the measured
    wave of 128 requests on seeds 1..64, its chunk launches counted."""
    faults = serve.FaultPlan(seed=0) if mode == "hardened" else None
    policy = (serve.BatchPolicy(max_batch=1, max_wait_s=0.0, max_queue=4096)
              if mode == "b1" else
              serve.BatchPolicy(max_batch=64, max_wait_s=SERVE_WAIT_S,
                                max_queue=4096))
    server = serve.SimServer(
        sessions=serve.SessionManager(cache=cache_dir, faults=faults,
                                      device=device),
        policy=policy, faults=faults,
        retry=serve.RetryPolicy() if mode == "hardened" else None)
    try:
        warm, _, _ = await _serve_wave(server, _serve_reqs(serve, 10_000))
        _served_ok(warm, f"serve {mode} warm-up")
        stats0 = server.stats()
        torch.cuda.synchronize()
        kv.reset_counts()
        resps, wall, lats = await _serve_wave(server, _serve_reqs(serve, 1))
        torch.cuda.synchronize()
        counts = dict(kv.COUNTS)
        _served_ok(resps, f"serve {mode}")
        if counts["vcycle_chunk"] <= 0 or counts["vcycle_seed"]:
            raise AssertionError(f"serve {mode}: launched {counts}")
        stats = server.stats()
        launches = stats["batcher"]["launches"] - \
            stats0["batcher"]["launches"]
        launched = stats["batcher"]["launched_requests"] - \
            stats0["batcher"]["launched_requests"]
        row = {"mode": mode, "n_requests": len(resps), "wall_s": wall,
               "rps": len(resps) / wall,
               "p50_ms": float(np.percentile(lats, 50) * 1e3),
               "p95_ms": float(np.percentile(lats, 95) * 1e3),
               "launches": launches, "mean_batch": launched / launches,
               "mean_run_s": float(np.mean([r.run_s for r in resps])),
               "chunk_launches": counts["vcycle_chunk"],
               "engine_kinds": sorted({r.engine_kind for r in resps}),
               "stages_per_launch": _stages(stats0["stages"],
                                            stats["stages"]),
               "warm_up_stages_per_launch": _stages(
                   dict.fromkeys(stats0["stages"], 0), stats0["stages"])}
        return row, resps
    finally:
        await server.close()


async def _serve_chaos(serve, chaos_drill, poison_seeds, cache_dir, device):
    """``python -m repro_torch.serve --chaos-drill``'s server and plan
    (p=0.2 at the four sites, poison seeds 666/667) on CHAOS_N requests
    at full scale; the drill's own report is returned, not printed."""
    plan = serve.FaultPlan.chaos(seed=0, p=0.2, poison_seeds=poison_seeds)
    server = serve.SimServer(
        sessions=serve.SessionManager(cache=cache_dir, faults=plan,
                                      breaker_cooldown_s=0.2,
                                      device=device),
        policy=serve.BatchPolicy(max_batch=64, max_wait_s=0.02,
                                 max_queue=256),
        faults=plan, retry=serve.RetryPolicy(
            max_attempts=8, backoff_base_s=0.01, max_extra_launches=32))
    server.sessions.compile_retries = 6
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = await chaos_drill(server, list(SERVE_NAMES), SERVE_SCALE,
                               CHAOS_N, plan)
    await server.close(drain=True)
    return rc, log.getvalue().splitlines(), server.stats()["launch"]


def phase_serve(torch, kv, sim, serve, IsaEngine, device=None):
    """The main path's last stage: ``repro_torch.serve.SimServer`` in this
    process, in bench_serve.py's three modes; every served result equal
    to a direct ``sim.compile(name, seeds=...).run()`` and, on four seeds
    a circuit, to IsaSim; then the chaos drill and the CLI's self-test."""
    from repro_torch.serve.__main__ import POISON_SEEDS, chaos_drill
    t_phase = time.perf_counter()
    seeds = list(range(1, 1 + SERVE_PER_CIRCUIT))
    with tempfile.TemporaryDirectory(prefix="serve-cache-") as cache_dir:
        modes, served = {}, {}
        for mode in SERVE_MODES:
            modes[mode], served[mode] = asyncio.run(
                _serve_mode(torch, kv, serve, mode, cache_dir, device))
        direct = {}
        for name in SERVE_NAMES:
            s = sim.compile(name, scale=SERVE_SCALE, seeds=seeds,
                            cache=cache_dir, device=device)
            results = s.run()
            if not all(r.finished for r in results):
                raise AssertionError(f"serve: direct {name} run unfinished")
            stacked = s.images_stacked()
            for i in range(SERVE_ISA_SEEDS):
                ref = IsaEngine(s.program, images=tuple(a[i] for a in
                                                        stacked)) \
                    .run(s.default_cycles())
                if _result_key(ref, False) != _result_key(results[i],
                                                           False):
                    raise AssertionError(f"serve: {name} seed {seeds[i]} "
                                         "direct run != IsaSim")
            direct[name] = dict(zip(seeds, results))
        for mode, resps in served.items():
            for req, resp in zip(_serve_reqs(serve, 1), resps):
                if _result_key(resp.result) != \
                        _result_key(direct[req.circuit][req.seed]):
                    raise AssertionError(
                        f"serve {mode}: {req.circuit} seed {req.seed} "
                        "!= the direct run")
        t0 = time.perf_counter()
        rc, drill_log, drill_launch = asyncio.run(_serve_chaos(
            serve, chaos_drill, POISON_SEEDS, cache_dir, device))
        chaos_s = time.perf_counter() - t0
        if rc:
            raise AssertionError("serve: chaos drill failed: "
                                 + " | ".join(drill_log))
        cli = [sys.executable, "-m", "repro_torch.serve", "--self-test",
               "--scale", SERVE_SCALE, "--cache-dir", cache_dir]
        if device is not None:
            cli += ["--device", str(device)]
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(cli, capture_output=True, text=True,
                             timeout=600, cwd=ROOT, env=env)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0 or "self-test ok" not in out.stdout:
            raise AssertionError(f"serve: CLI self-test failed "
                                 f"({out.returncode}): {out.stdout[-2000:]}"
                                 f"{out.stderr[-2000:]}")
    chunk_launches = sum(m["chunk_launches"] for m in modes.values())
    emit({"phase": "serve", "circuits": list(SERVE_NAMES),
          "scale": SERVE_SCALE, "grid": "15x15",
          "modes": modes, "all_ok": True, "equal_to": [
              f"sim.compile(name, seeds=1..{SERVE_PER_CIRCUIT}).run()",
              f"IsaSim ({SERVE_ISA_SEEDS} seeds a circuit)"],
          "chaos_drill": {"n": CHAOS_N, "seconds": chaos_s,
                          "launch": drill_launch,
                          "report": drill_log[:1]},
          "cli_self_test": {"cmd": " ".join(cli[1:]), "seconds": cli_s,
                            "last_line": out.stdout.strip()
                            .splitlines()[-1]},
          "chunk_launches": chunk_launches,
          "seconds": time.perf_counter() - t_phase})
    return chunk_launches


def phase_elastic(torch, kv, sim, elastic, HardwareConfig, FINISH,
                  device=None):
    """examples/simulate_accelerator.py on the port: each case compiled
    for a small grid and for 15x15, run half way on the small one through
    ``machine``, migrated by RTL name, run to its end on 15x15; it must
    FINISH at exactly ``n_cycles`` with the registers of an uninterrupted
    15x15 run."""
    cases, launches = [], 0
    with tempfile.TemporaryDirectory(prefix="elastic-cache-") as cache_dir:
        for name, side in ELASTIC_CASES:
            sa = sim.compile(name, HardwareConfig(grid_width=side,
                                                  grid_height=side),
                             scale="full", cache=cache_dir, device=device)
            sb = sim.compile(name, HardwareConfig(), scale="full",
                             cache=cache_dir, device=device)
            n = sb.n_cycles
            half = n // 2
            ea, eb = sa.engine(), sb.engine()
            torch.cuda.synchronize()
            kv.reset_counts()
            t0 = time.perf_counter()
            ra = ea.run(half)
            eb.state = elastic.migrate(sa.program, ea.state, sb.program,
                                       eb.m)
            rb = eb.run(n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kv.COUNTS)
            if counts["vcycle_chunk"] <= 0 or counts["vcycle_seed"]:
                raise AssertionError(f"elastic {name}: launched {counts}")
            launches += counts["vcycle_chunk"]
            ref = sb.run()
            if ra.cycles != half or ra.exceptions:
                raise AssertionError(f"elastic {name}: first half ran "
                                     f"{ra.cycles} ({ra.exceptions})")
            if set(rb.exceptions.values()) != {FINISH} \
                    or ra.cycles + rb.cycles != n:
                raise AssertionError(
                    f"elastic {name}: ended at {ra.cycles + rb.cycles} "
                    f"with {rb.exceptions}, not FINISH at {n}")
            if ref.cycles != n or rb.registers != ref.registers \
                    or rb.exceptions != ref.exceptions:
                raise AssertionError(f"elastic {name}: migrated run != "
                                     "an uninterrupted 15x15 run")
            cases.append({"circuit": name, "from": f"{side}x{side}",
                          "to": "15x15", "n_cycles": n, "half": half,
                          "finished_at": ra.cycles + rb.cycles,
                          "registers_checked": len(rb.registers),
                          "vcpl": [sa.program.vcpl, sb.program.vcpl],
                          "prologue_slots": [sa.program.pipe_prologue,
                                             sb.program.pipe_prologue],
                          "cores": [sa.program.used_cores,
                                    sb.program.used_cores],
                          "chunk_launches": counts["vcycle_chunk"],
                          "wall_s": wall})
    emit({"phase": "elastic", "cases": cases,
          "equal_to": "an uninterrupted 15x15 run",
          "chunk_launches": launches})
    return launches


# the multi-device engines (ROADMAP A6, A7) on a one-card machine: D
# shards of cuda:0 test the logic of the sharding and of the exchange, not
# the speed of copies between cards
MULTI_DEV = "cuda:0"
MULTI_D = (1, 4)
SHARDED_B = 510            # padded to 512 over 4 shards: 2 padding elements
MULTI_SEEDS = 64           # bc's sharded batch, and each batched grid's
MULTI_ISA = (0, 300, 509)  # elements on shards 0, 2 and 3, held to IsaSim
STATE_LEAVES = ("regs", "spads", "gmem", "flags", "cache_tags", "counters")


def one_card(D: int) -> list:
    """D shards of one card, the devices of every multi-device case here
    (``scripts/multi_card.py`` gives each shard its own card)."""
    return [MULTI_DEV] * D


def _shards_on(devices) -> str:
    names = [str(d) for d in devices]
    return (f"{len(names)} x {names[0]}" if len(set(names)) == 1
            else ", ".join(names))


def _label(devices) -> str:
    if len({str(d) for d in devices}) == 1:
        return ("D shards on one card: the logic of sharding and of the "
                "exchange, not copies between cards")
    return "one shard a card: the exchange crosses cards"


def _sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _synced(torch, fn):
    """(fn(), seconds): host clock around work that ends in a sync of
    every card."""
    _sync_all(torch)
    t0 = time.perf_counter()
    out = fn()
    _sync_all(torch)
    return out, time.perf_counter() - t0


def _equal_leaves(torch, got, want, tag):
    """Two states leaf by leaf, bit for bit (int32 tensors or uint32/int32
    arrays, on any device)."""
    for name, a, b in zip(STATE_LEAVES, got, want):
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        if a.shape != b.shape or not np.array_equal(
                a.view(np.uint32), b.view(np.uint32)):
            raise AssertionError(f"{tag}: {name} differs")


def phase_sharded(torch, kv, sim, bsp, IsaEngine, FINISH, s_mc, results,
                  place=one_card):
    """``ShardedBatchedMachine`` on D shards of the card, each element
    bit-equal to ``BatchedMachine`` on the same images: mc/full at B=512
    (D=1) and B=510 (D=4, two padding elements), bc/full (pipelined) at
    B=64 over 4 shards; then the user's call
    ``compile("mc", seeds=range(512)).run(engine="sharded", devices=...)``,
    counted, equal to the main path's results and to IsaSim. ``place(D)``
    gives the devices of D shards."""
    t_phase = time.perf_counter()
    dev0 = place(1)[0]
    s_bc = sim.compile("bc", scale="full", seeds=range(MULTI_SEEDS))
    cases = []
    for s, name, B, D in ((s_mc, "mc", MAIN_SEEDS, 1),
                          (s_mc, "mc", SHARDED_B, 4),
                          (s_bc, "bc", MULTI_SEEDS, 4)):
        tag = f"sharded {name} B={B} D={D}"
        images = tuple(a[:B] for a in s.images_stacked())
        n = s.default_cycles()
        bm = bsp.BatchedMachine(s.program, images=images, device=dev0)
        sm = bsp.ShardedBatchedMachine(s.program, images=images,
                                       devices=place(D))
        sb, t_b = _synced(torch, lambda: bm.run(bm.init_state(), n))
        kv.reset_counts()
        st, t_s = _synced(torch, lambda: sm.run(sm.init_state(), n))
        launches = kv.COUNTS["vcycle_chunk"]
        g = sm.gather(st)
        _equal_leaves(torch, [x[:B] for x in g], sb, tag)
        if g.flags[B:].any() or g.counters[B:].any():
            raise AssertionError(f"{tag}: a padding element ran")
        p = sm.perf(st)
        vc = g.counters[:B, 0]
        if (p["batch"] != B or len(sm.exceptions(st)) != B
                or not bool((vc == s.n_cycles).all())
                or not bool((g.flags[:B] == FINISH).any(1).all())):
            raise AssertionError(f"{tag}: not every element FINISHed at "
                                 f"{s.n_cycles} ({p})")
        _, t_b2 = _synced(torch, lambda: bm.run(bm.init_state(), n))
        _, t_s2 = _synced(torch, lambda: sm.run(sm.init_state(), n))
        cases.append({"circuit": name, "B": B, "D": D, "Bp": sm.Bp,
                      "shards_on": _shards_on(place(D)),
                      "chunk_launches": launches,
                      "vcycles": p["vcycles"], "pipe_prologue":
                      s.program.pipe_prologue,
                      "vcycles_per_s": [p["vcycles"] / t_s,
                                        p["vcycles"] / t_s2],
                      "batched_vcycles_per_s": [p["vcycles"] / t_b,
                                                p["vcycles"] / t_b2],
                      "equal_to": "BatchedMachine"})
    # the user's call, counted
    devices = place(4)
    torch.cuda.synchronize()
    kv.reset_counts()
    out, run_s = _synced(torch, lambda: s_mc.run(engine="sharded",
                                                 devices=devices))
    launches = kv.COUNTS["vcycle_chunk"]
    if launches <= 0 or kv.COUNTS["vcycle_seed"]:
        raise AssertionError(f"sharded path launched {dict(kv.COUNTS)}")
    if out != results:
        raise AssertionError("run(engine='sharded') != the main path's "
                             "results")
    stacked = s_mc.images_stacked()
    for i in MULTI_ISA:
        ref = IsaEngine(s_mc.program, images=tuple(a[i] for a in stacked)) \
            .run(s_mc.default_cycles())
        if (ref.cycles, ref.exceptions, ref.registers) != \
                (out[i].cycles, out[i].exceptions, out[i].registers):
            raise AssertionError(f"sharded element {i} != IsaSim")
    emit({"phase": "sharded", "cases": cases,
          "call": "repro_torch.sim.compile('mc', scale='full', "
                  f"seeds=range({MAIN_SEEDS})).run(engine='sharded', "
                  f"devices=[{_shards_on(devices)}])",
          "label": _label(devices),
          "launches": launches, "run_s": run_s,
          "equal_to": ["main path results", "BatchedMachine", "IsaSim"],
          "isasim_checked": list(MULTI_ISA),
          "seconds": time.perf_counter() - t_phase})
    return launches, s_bc


def _device_busy_ms(torch, fn) -> tuple:
    """(device ms, launches of ``vcycle_chunk_kernel``) in a
    ``torch.profiler`` trace of one call of ``fn``: every kernel and copy
    it ran on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, seen = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == cuda:
            us += float(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)))
            if "vcycle_chunk_kernel" in e.key:
                seen += e.count
    return us / 1e3, seen


def phase_grid(torch, kv, bsp, GridMachine, FINISH, sims, place=one_card):
    """``GridMachine`` on D shards of the card (the cores sharded, SENDs
    crossing shards every Vcycle), unbatched against ``Machine`` and on
    64 seeds against ``BatchedMachine``, bit for bit, on mc/full and
    bc/full (modulo-pipelined; the grid runs it unrotated) at D=1 and
    D=4; each FINISHes at its bench's cycle. Each mc case reports its
    device time in a trace of one run over the host time of an untraced
    one (``device_busy_share``). ``place(D)`` gives the devices of D
    shards."""
    t_phase = time.perf_counter()
    cases, total = [], 0
    dev0 = place(1)[0]
    for name, s in sims:
        prog, n = s.program, s.default_cycles()
        C = prog.used_cores
        images = tuple(a[:MULTI_SEEDS] for a in s.images_stacked())
        m = bsp.Machine(prog, device=dev0)
        s1 = m.run(m.init_state(), n)
        bm = bsp.BatchedMachine(prog, images=images, device=dev0)
        sB = bm.run(bm.init_state(), n)
        for D in MULTI_D:
            for batched in (False, True):
                tag = f"grid {name} D={D} {'B=64' if batched else 'B=1'}"
                gm = GridMachine(prog, place(D),
                                 images=images if batched else None)
                if D > 1 and not gm.cross_words:
                    raise AssertionError(f"{tag}: no SEND crosses shards")
                kv.reset_counts()
                st, t1 = _synced(torch, lambda: gm.run(gm.init_state(), n))
                launches = kv.COUNTS["vcycle_chunk"]
                total += launches
                h = gm.gather(st)
                ref, B = (sB, MULTI_SEEDS) if batched else (s1, 1)
                lead = (slice(None),) if batched else ()
                gs = (*lead, gm.gshard)
                _equal_leaves(torch, [h.regs[(*lead, slice(0, C))],
                                      h.spads[(*lead, slice(0, C))],
                                      h.gmem[gs],
                                      h.flags[(*lead, slice(0, C))],
                                      h.cache_tags[gs], h.counters[gs]],
                              ref, tag)
                vc = h.counters[(*lead, slice(None), 0)]
                exc = gm.exceptions(st)
                exc = exc if batched else [exc]
                if not (vc == s.n_cycles).all() or \
                        any(set(e.values()) != {FINISH} for e in exc):
                    raise AssertionError(f"{tag}: not FINISHed at "
                                         f"{s.n_cycles} on every shard")
                if launches % D or launches // D % gm.chunk:
                    raise AssertionError(f"{tag}: {launches} launches, "
                                         f"not D per Vcycle of a chunk")
                _, t2 = _synced(torch, lambda: gm.run(gm.init_state(), n))
                busy_ms = traced = None
                if name == "mc":        # a trace costs seconds: one circuit
                    busy_ms, traced = _device_busy_ms(
                        torch, lambda: gm.run(gm.init_state(), n))
                vcycles = B * s.n_cycles
                cases.append({
                    "circuit": name, "D": D, "B": B, "C": C, "cl": gm.cl,
                    "outbox_cores": gm.n_box, "n_sends": prog.n_sends,
                    "crossing_sends": gm.cross_words,
                    "exchange_bytes_per_vcycle": 4 * B * gm.cross_words,
                    "pipe_prologue": prog.pipe_prologue,
                    "shards_on": _shards_on(place(D)),
                    "finished_at": s.n_cycles, "chunk_launches": launches,
                    "vcycles_dispatched": launches // D,
                    "vcycles_per_s": [vcycles / t1, vcycles / t2],
                    "device_ms": busy_ms, "traced_launches": traced,
                    "device_busy_share": busy_ms and busy_ms / (1e3 * t2),
                    "equal_to": "BatchedMachine" if batched else "Machine"})
    emit({"phase": "grid", "cases": cases, "label": _label(place(4)),
          "chunk_launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


# the flash kernel's shapes: (BH, BHkv, S, dh, dtype, causal)
FLASH_CASES = (
    # tests/test_kernels.py:122-127
    (2, 2, 256, 64, "float32", True),
    (2, 2, 256, 64, "float32", False),
    (4, 4, 512, 128, "bfloat16", True),
    (1, 1, 128, 32, "float32", True),
    (3, 3, 384, 64, "bfloat16", True),
    # the qwen3-0.6b prefill: B=4 x H=16 query heads over Hkv=8 (G=2)
    (LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, 128, "bfloat16", True),
    # the deepseek-moe-16b prefill: B=4 x H=16 over Hkv=16 (G=1), and its
    # float32 check's full forward over S+1 tokens
    (LM_BATCH * 16, LM_BATCH * 16, LM_PROMPT, 128, "bfloat16", True),
    (16, 16, LM_PROMPT + 1, 128, "float32", True),
    (16, 8, LM_PROMPT + 1, 128, "float32", True),
    (8, 4, 512, 128, "bfloat16", False),
    (6, 3, 1000, 64, "bfloat16", True),
    # the zamba2-7b prefill's shared attention: B=4 x H=32 over Hkv=32,
    # dh = 3584 / 32 = 112, so bf16 on the wgmma kernel at a tile width of
    # 128, the columns past 112 zero
    (LM_BATCH * 32, LM_BATCH * 32, LM_PROMPT, 112, "bfloat16", True),
    # a padded head dim under GQA (G 3) with a ragged tail tile, not causal
    (6, 2, 1000, 96, "bfloat16", False),
    # whisper-medium: its encoder over 1500 frames (B=4 x H=16, dh = 64,
    # not causal; a ragged tail tile of 92 rows) and its decoder's prefill
    # over 224 tokens
    (LM_BATCH * 16, LM_BATCH * 16, 1500, 64, "bfloat16", False),
    (LM_BATCH * 16, LM_BATCH * 16, 224, 64, "bfloat16", True),
    # the qwen2-vl-72b prefill: B=4 x H=64 over Hkv=8 (G=8), 256 patches
    # and 2048 tokens
    (LM_BATCH * 64, LM_BATCH * 8, 256 + LM_PROMPT, 128, "bfloat16", True),
    # the starcoder2-3b prefill: B=4 x H=24 over Hkv=2 (G=12), and one
    # key tile of the same heads
    (LM_BATCH * 24, LM_BATCH * 2, LM_PROMPT, 128, "bfloat16", True),
    (LM_BATCH * 24, LM_BATCH * 2, 17, 128, "bfloat16", True),
    # the dryrun phase's qwen3-0.6b train step, B=2 x S=4096
    (2 * 16, 2 * 8, 4096, 128, "bfloat16", True),
)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# each output row's error over its size, ||o - ref|| / ||ref||, at the
# worst row: on these random inputs |o| falls as 1/sqrt(keys), so past a
# few thousand keys FLASH_TOL's absolute limit exceeds the values
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def flash_row_err(o, ref) -> float:
    """The largest over rows of ||o - ref|| / ||ref||, in float32."""
    ref = ref.float()
    return float(((o.float() - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def flash_inputs(torch, BH, BHkv, S, dh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((n, S, dh), generator=g, device="cuda")
                 .to(getattr(torch, dtype)) for n in (BH, BHkv, BHkv))


def tf32_rounding(torch, kbuild) -> dict:
    """tf32x3.cuh's integer rounding to TF32 against ``cvt.rna.tf32.f32``
    on the card: normal floats over 60 binades and the same with their
    last 13 bits set to a tie; it raises on a mismatch."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(1 << 22, generator=g, device="cuda") * torch.exp2(
        torch.randint(-30, 30, (1 << 22,), generator=g, device="cuda")
        .float())
    x = torch.cat([x, ((x.view(torch.int32) & ~0x1fff) | 0x1000)
                   .view(torch.float32)])
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    kbuild.check("tf32x3_rounding_mismatches",
                 kbuild.load().tf32x3_rounding_mismatches(
                     x.data_ptr(), x.numel(), count.data_ptr(),
                     torch.cuda.current_stream().cuda_stream))
    if int(count):
        raise AssertionError(f"tf32 rounding: {int(count)} of {x.numel()} "
                             "differ from cvt.rna.tf32.f32")
    return {"values": x.numel(), "mismatches": int(count)}


def _f64(*ts):
    return tuple(t.double() for t in ts)


def phase_flash(torch, fa, flash_ref, kbuild):
    """Each case through ``flash_attention`` against the plain version on
    the same CUDA tensors, with the kernel that ran (one launch, the one
    ``route`` names); fp32 within 1e-4 (sums in another order), bf16
    within 2e-2 (P and the output rounded to bf16), and each row within
    FLASH_ROW_TOL of its size; the error against ``flash_ref`` in float64
    beside it. The cases on
    ``flash_attention_simt`` also through its lse route: the same output
    with ``return_lse``, one launch, lse within 1e-5 (fp32) or 1e-4 (bf16)
    of ``flash_ref``'s, and its error in float64."""
    rounding = tf32_rounding(torch, kbuild)
    cases = []
    for i, (BH, BHkv, S, dh, dtype, causal) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, BH, BHkv, S, dh, dtype, i)
        fa.reset_counts()
        out = fa.flash_attention(q, k, v, causal)
        ran = [name for name, n in fa.COUNTS.items() for _ in range(n)]
        ref = flash_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = FLASH_TOL[dtype]
        tag = (f"flash BH={BH} BHkv={BHkv} S={S} dh={dh} {dtype} "
               f"causal={causal}")
        if ran != [fa.route(q.dtype, dh)]:
            raise AssertionError(f"{tag}: launched {ran}")
        row = flash_row_err(out, ref)
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"{tag}: {ran[0]} != plain (max abs err "
                                 f"{err})")
        if not row <= FLASH_ROW_TOL[dtype]:
            raise AssertionError(f"{tag}: {ran[0]} != plain (a row {row} "
                                 "of its size off)")
        o64, lse64 = flash_ref(*_f64(q, k, v), causal, return_lse=True)
        case = {"BH": BH, "BHkv": BHkv, "S": S, "dh": dh, "dtype": dtype,
                "causal": causal, "kernel": ran[0], "max_abs_err": err,
                "tol": tol, "row_rel_err": row,
                "row_tol": FLASH_ROW_TOL[dtype], "max_abs_err_float64": float(
                    (out.double() - o64).abs().max())}
        if ran[0] == "flash_attention_simt":
            fa.reset_counts()
            o, lse = fa.flash_attention_simt(q, k, v, causal,
                                             return_lse=True)
            launches = dict(fa.COUNTS)
            lse_ref = flash_ref(q, k, v, causal, return_lse=True)[1]
            torch.cuda.synchronize()
            lse_tol = 1e-5 if dtype == "float32" else 1e-4
            if launches["flash_attention_simt"] != 1 or sum(
                    launches.values()) != 1:
                raise AssertionError(f"{tag} lse: launched {launches}")
            if not torch.equal(o, out):
                raise AssertionError(f"{tag}: the output with lse differs")
            if not torch.allclose(lse, lse_ref, rtol=lse_tol, atol=lse_tol):
                raise AssertionError(f"{tag}: lse != flash_ref's (max abs "
                                     f"err {(lse - lse_ref).abs().max()})")
            case["lse"] = {
                "max_abs_err": float((lse - lse_ref).abs().max()),
                "tol": lse_tol, "max_abs_err_float64": float(
                    (lse.double() - lse64).abs().max())}
        cases.append(case)
        del q, k, v, out, ref, o64, lse64
    torch.cuda.empty_cache()
    emit({"phase": "flash_vs_plain", "tf32_rounding": rounding,
          "cases": cases})
    return max(c["max_abs_err"] for c in cases)


def _grad_errs(torch, got, want, again, tol, tag):
    """Each of (dq, dk, dv) against the plain version within ``tol`` of its
    max, and bit-equal to a second launch: ({name: max abs err},
    {name: err over max})."""
    err, rel = {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err[name] = float((a.float() - b.float()).abs().max())
        rel[name] = err[name] / float(b.float().abs().max())
        if a.dtype != b.dtype or not rel[name] <= tol:
            raise AssertionError(f"{tag}: {name} != plain ({err[name]}, "
                                 f"{rel[name]} of its max)")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: a second launch gave other bits")
    return err, rel


def phase_flash_bwd(torch, fa, flash_bwd_ref, flash_ref):
    """``flash_attention_bwd`` at each of ``flash_vs_plain``'s cases, on
    the gradient ``dO`` of that case's forward output (the forward kernel
    ``route`` picks), against ``flash_bwd_ref`` on the same CUDA tensors:
    each of dq, dk, dv within 1e-4 (fp32) or 2e-2 (bf16) of its max; one
    launch each, and the same bits when launched again (no atomics). At
    the bf16 cases with dh in ``SM90_HEAD_DIMS`` also
    ``flash_attention_bwd_sm90``
    with the lse that ``flash_attention_sm90`` saves, against
    ``flash_bwd_ref(..., lse=)``: within 2e-2 of each output's max, one
    launch, the same bits again; and that lse within 1e-3 of
    ``flash_ref``'s. At the cases ``route`` sends to
    ``flash_attention_simt`` also ``flash_attention_bwd`` given that
    kernel's lse, against ``flash_bwd_ref(..., lse=)`` within 1e-4 or 2e-2
    of each output's max, one launch, the same bits again, with each
    output's error against ``flash_bwd_ref`` in float64."""
    cases = []
    zero = {name: 0 for name in fa.COUNTS}
    for i, (BH, BHkv, S, dh, dtype, causal) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, BH, BHkv, S, dh, dtype, 50 + i)
        do = flash_inputs(torch, BH, BHkv, S, dh, dtype, 80 + i)[0]
        o = fa.flash_attention(q, k, v, causal)
        fa.reset_counts()
        got = fa.flash_attention_bwd(q, k, v, o, do, causal)
        launches = dict(fa.COUNTS)
        again = fa.flash_attention_bwd(q, k, v, o, do, causal)
        want = flash_bwd_ref(q, k, v, o, do, causal)
        torch.cuda.synchronize()
        tag = (f"flash bwd BH={BH} BHkv={BHkv} S={S} dh={dh} {dtype} "
               f"causal={causal}")
        if launches != {**zero, "flash_attention_bwd": 1}:
            raise AssertionError(f"{tag}: launched {launches}")
        tol = FLASH_TOL[dtype]
        err, rel = _grad_errs(torch, got, want, again, tol, tag)
        case = {"BH": BH, "BHkv": BHkv, "S": S, "dh": dh, "dtype": dtype,
                "causal": causal, "max_abs_err": err, "err_over_max": rel,
                "tol": tol}
        del got, again, want
        if fa.route(q.dtype, dh) == "flash_attention_simt":
            o, lse = fa.flash_attention_simt(q, k, v, causal,
                                             return_lse=True)
            fa.reset_counts()
            got = fa.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
            launches = dict(fa.COUNTS)
            again = fa.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
            want = flash_bwd_ref(q, k, v, o, do, causal, lse=lse)
            torch.cuda.synchronize()
            if launches != {**zero, "flash_attention_bwd": 1}:
                raise AssertionError(f"{tag} lse: launched {launches}")
            err, rel = _grad_errs(torch, got, want, again, tol, f"{tag} lse")
            q64, k64, v64, do64 = _f64(q, k, v, do)
            want64 = flash_bwd_ref(q64, k64, v64,
                                   flash_ref(q64, k64, v64, causal), do64,
                                   causal)
            case["lse_route"] = {
                "max_abs_err": err, "err_over_max": rel, "tol": tol,
                "max_abs_err_float64": {
                    name: float((a.double() - b).abs().max())
                    for name, a, b in zip(("dq", "dk", "dv"), got, want64)},
                "err_over_max_float64": {
                    name: float((a.double() - b).abs().max()
                                / b.abs().max())
                    for name, a, b in zip(("dq", "dk", "dv"), got, want64)}}
            del got, again, want, want64, q64, k64, v64, do64, lse
        if dtype == "bfloat16" and dh in fa.SM90_HEAD_DIMS:
            o, lse = fa.flash_attention_sm90(q, k, v, causal,
                                             return_lse=True)
            lse_err = float((lse - flash_ref(q, k, v, causal,
                                             return_lse=True)[1])
                            .abs().max())
            if not lse_err <= 1e-3:
                raise AssertionError(f"{tag}: the forward's lse is "
                                     f"{lse_err} off flash_ref's")
            fa.reset_counts()
            got = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
            launches = dict(fa.COUNTS)
            again = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
            want = flash_bwd_ref(q, k, v, o, do, causal, lse=lse)
            torch.cuda.synchronize()
            if launches != {**zero, "flash_attention_bwd_sm90": 1}:
                raise AssertionError(f"{tag} sm90: launched {launches}")
            err, rel = _grad_errs(torch, got, want, again, tol,
                                  f"{tag} sm90")
            case["flash_attention_bwd_sm90"] = {
                "max_abs_err": err, "err_over_max": rel, "tol": tol,
                "lse_max_abs_err": lse_err}
            del got, again, want, lse
        cases.append(case)
        del q, k, v, o, do
    torch.cuda.empty_cache()
    emit({"phase": "flash_bwd_vs_plain", "cases": cases})


def _full_forward_last(torch, model, L, params, tokens, extra=None):
    """Last-position logits of a full forward over ``tokens`` (after a
    VLM's ``patches``, over a whisper batch's ``frames``: ``extra``)."""
    x, pos, enc_out, _ = model._embed_inputs(
        params, {"tokens": tokens, **(extra or {})})
    h, _ = model._trunk(params, x, pos, enc_out=enc_out)
    return L.unembed(params["embed"], model.cfg, h[:, -1:]).float()


def _greedy(torch, model, params, logits, cache, n, start=LM_PROMPT):
    """The ``n`` greedy tokens after prefill ``logits`` (decoding in place
    from position ``start``) and the first decode step's logits."""
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    toks, first = [tok], None
    for i in range(n - 1):
        logits, cache = model.decode_step(params, tok, cache, start + i)
        first = logits if first is None else first
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks.append(tok)
    return torch.cat(toks, 1), first


def _start(extra, S):
    """The first decode position after a prompt of S tokens: past a VLM's
    patches too."""
    return S + (extra["patches"].shape[1] if "patches" in (extra or {})
                else 0)


def _spy_routes(MOE, out):
    """A patch of ``MOE.route`` appending each route it gives to
    ``out`` (on the card, no sync)."""
    from unittest import mock
    inner = MOE.route

    def spy(*a, **kw):
        r = inner(*a, **kw)
        out.append(r)
        return r

    return mock.patch.object(MOE, "route", spy)


def _serve(torch, fa, kv, steps, cfg, seed, n_decode, ctx, want,
           MOE=None, repeats=3, S=LM_PROMPT, extra=None, keep=None,
           routes=None):
    """``cfg`` in its bf16 through ``make_serve_steps`` on the card:
    parameters from a ``torch.Generator`` seeded ``seed`` (the init's peak
    bytes), LM_BATCH prompts of S tokens from a numpy seed (after a VLM's
    patches, over a whisper batch's frames: ``extra``, decoding from
    ``_start``), a cache
    for ``ctx``; one counted prefill and ``n_decode`` greedy steps, which
    must launch the flash kernels ``want`` names as many times as it says
    ({kernel: launches}) and nothing else; then ``repeats`` synced
    prefills and the decode loop again, timed; with ``MOE`` a last
    prefill recording each layer's dropped share; with a list ``keep``
    the counted prefill's logits appended to it (on the host), with a
    list ``routes`` each of its MoE layers' route (``_spy_routes``).
    Returns
    (the prompts, the numbers). Peak bytes are ``max_memory_allocated``,
    with what was allocated before the init (``base_bytes``) beside
    them."""
    model, prefill_step, decode_step = steps.make_serve_steps(cfg)
    tokens = torch.from_numpy(np.random.default_rng(seed + 13).integers(
        0, cfg.vocab, (LM_BATCH, S))).cuda()
    batch = {"tokens": tokens, **(extra or {})}
    start = _start(extra, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    cache = model.make_cache(LM_BATCH, ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path, counted: one prefill and n_decode greedy steps
    fa.reset_counts()
    kv.reset_counts()
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if routes is None
          else _spy_routes(MOE, routes)):
        logits, cache = prefill_step(params, batch, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(n_decode):
        tok, cache = decode_step(params, tok, cache, start + i)
        out.append(tok)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if keep is not None:
        keep.append(logits.float().cpu())
    counts = dict(fa.COUNTS)
    if (counts != {**{k: 0 for k in counts}, **want}
            or any(kv.COUNTS.values())):
        raise AssertionError(f"{cfg.name} serving launched {counts} (not "
                             f"{want} and nothing else), Vcycle kernels "
                             f"{kv.COUNTS}")
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, 1)
    if (not bool(torch.isfinite(logits).all())
            or logits.shape != (LM_BATCH, 1, cfg.vocab)
            or gen.shape != (LM_BATCH, n_decode + 1)
            or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab):
        raise AssertionError(f"{cfg.name} serving gave non-finite logits "
                             "or bad tokens")
    # prefill tokens/s: synced prefills after the one above
    prefill_s = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, batch, cache)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    # decode tokens/s: the n_decode-step loop again, on the fresh cache
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_decode):
        tok, cache = decode_step(params, tok, cache, start + i)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    res = {"arch": cfg.name, "call": "repro_torch.launch.steps."
           f"make_serve_steps(ARCHS['{cfg.name}'])",
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "params": n_params, "dtype": cfg.dtype,
           "B": LM_BATCH, "S": S, "ctx": ctx,
           "inputs": {k: list(v.shape) for k, v in batch.items()},
           "decode_steps": n_decode, "launches_per_run": counts,
           "first_run_s": first_s, "prefill_s": prefill_s,
           "prefill_tokens_per_s": [LM_BATCH * S / t for t in prefill_s],
           "decode_s": decode_s,
           "decode_tokens_per_s": LM_BATCH * n_decode / decode_s,
           "peak_memory_bytes": peak, "base_bytes": base,
           "init_s": init_s, "init_peak_bytes": init_peak}
    if MOE is not None:
        _, calls = _spy_moe(MOE, lambda: prefill_step(params, batch, cache))
        if len(calls) != cfg.n_layers:
            raise AssertionError(f"{cfg.name}: {len(calls)} MoE calls in a "
                                 f"prefill of {cfg.n_layers} layers")
        res["dropped_share_by_layer"] = [c[2] for c in calls]
        del calls
    del params, cache, logits
    torch.cuda.empty_cache()
    return tokens, res


def _fp32_checks(torch, fa, flash_ref, steps, L, cfg, tokens, ctx,
                 want=None, extra=None):
    """``cfg`` in float32 at full width on the card, on ``tokens`` (after
    or over ``extra``, as ``_serve``): (a) the kernel prefill (``want``
    ``flash_attention_simt`` launches, counted; one a layer unless given)
    == the same model on ``flash_ref`` (logits within 1e-3,
    LM_GREEDY_CHECK greedy tokens equal) and (b) the first decode step ==
    a full forward over the S+1 tokens (within 1e-3). Returns its
    numbers."""
    from unittest import mock
    cfg = cfg.scaled(dtype="float32")
    want = cfg.n_layers if want is None else want
    m32 = steps.make_serve_steps(cfg)[0]
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": tokens, **(extra or {})}
    start = _start(extra, tokens.shape[1])
    with torch.inference_mode():
        c_k = m32.make_cache(LM_BATCH, ctx)
        fa.reset_counts()
        lk, c_k = m32.prefill(p32, batch, c_k)
        launches32 = fa.COUNTS["flash_attention_simt"]
        if launches32 != want or fa.COUNTS["flash_attention_sm90"]:
            raise AssertionError(f"float32 prefill launched {fa.COUNTS} "
                                 f"(not {want} flash_attention_simt)")
        greedy_k, first = _greedy(torch, m32, p32, lk, c_k, LM_GREEDY_CHECK,
                                  start)
        del c_k
        full = _full_forward_last(torch, m32, L, p32, torch.cat(
            [tokens, greedy_k[:, :1]], 1), extra)
        with mock.patch.object(L, "flash_attention", flash_ref):
            c_p = m32.make_cache(LM_BATCH, ctx)
            lp, c_p = m32.prefill(p32, batch, c_p)
            greedy_p, _ = _greedy(torch, m32, p32, lp, c_p,
                                  LM_GREEDY_CHECK, start)
            del c_p
    torch.cuda.synchronize()
    err_a = float((lk - lp).abs().max())
    err_b = float((first - full).abs().max())
    if err_a > 1e-3 or not torch.equal(greedy_k, greedy_p):
        raise AssertionError(f"float32 {cfg.name} prefill: kernel != "
                             f"flash_ref model (logits {err_a}, greedy "
                             f"{greedy_k.tolist()} vs {greedy_p.tolist()})")
    if err_b > 1e-3:
        raise AssertionError(f"float32 {cfg.name} first decode step != full "
                             f"forward over S+1 tokens ({err_b})")
    del p32
    torch.cuda.empty_cache()
    return {"fp32_flash_attention_simt_launches_per_prefill": launches32,
            "fp32_prefill_vs_plain_max_abs_err": err_a,
            "fp32_greedy_tokens_equal": LM_GREEDY_CHECK,
            "fp32_first_decode_vs_full_forward_max_abs_err": err_b}


def phase_lm_serve(torch, fa, kv, flash_ref, steps, L, ARCHS, keep=None):
    """qwen3-0.6b at full width through ``make_serve_steps`` (``_serve``:
    one prefill, one ``flash_attention_sm90`` launch a layer, and LM_DECODE
    greedy steps in bf16; prefill and decode tokens/s), then
    ``_fp32_checks`` at all 28 layers. With a list ``keep``, the prefill's
    logits are appended to it. Returns the two kernels' launches on their
    paths."""
    cfg = ARCHS[LM_ARCH]
    tokens, res = _serve(torch, fa, kv, steps, cfg, 0, LM_DECODE, LM_CTX,
                         {"flash_attention_sm90": cfg.n_layers}, keep=keep)
    checks = _fp32_checks(torch, fa, flash_ref, steps, L, cfg, tokens,
                          LM_CTX)
    launches = res["launches_per_run"]["flash_attention_sm90"]
    emit({"phase": "lm_serve", **res,
          "flash_attention_sm90_launches_per_prefill": launches, **checks})
    return launches, checks["fp32_flash_attention_simt_launches_per_prefill"]


MOE_ARCH = "deepseek-moe-16b"
MOE_DECODE = 32
MOE_CTX = LM_PROMPT + MOE_DECODE
MOE_CHECK_LAYERS = 2      # the float32 checks, as lm_train's
MOE_SEED = 4              # deepseek's params; its prompts from MOE_SEED + 13
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_DECODE = "mixtral-8x7b", 16, 8


def _spy_moe(MOE, fn):
    """``fn()`` with every ``MOE.moe_fwd`` call recorded as (its params,
    its input, the share of (token, k) pairs capacity dropped there, from
    ``MOE.route`` on that input)."""
    from unittest import mock
    calls, inner = [], MOE.moe_fwd

    def spy(p, cfg, x, *a, **kw):
        r = MOE.route(p, cfg, x.reshape(-1, cfg.d_model), *a, **kw)
        calls.append((p, x, float((~r.keep).float().mean())))
        return inner(p, cfg, x, *a, **kw)

    with mock.patch.object(MOE, "moe_fwd", spy):
        out = fn()
    return out, calls


def _no_drops(MOE, cfg):
    """``MOE.moe_fwd`` at capacity factor E/K: C = T, nothing dropped."""
    import functools
    from unittest import mock
    return mock.patch.object(MOE, "moe_fwd", functools.partial(
        MOE.moe_fwd, capacity_factor=cfg.n_experts / cfg.moe_top_k))


def _moe_reckoning(cfg, ctx) -> dict:
    """Bytes of the bf16 serving peak, from the shapes: the parameters,
    the K/V cache and the largest MoE layer's transients in a prefill (the
    [E*C, d] rows gathered, three [E, C, f] products, [E, C, d] out, the
    [T, K, d] rows gathered back and their fp32 copy)."""
    E, K, d = cfg.n_experts, cfg.moe_top_k, cfg.d_model
    f = cfg.d_ff_expert or cfg.d_ff
    T = LM_BATCH * LM_PROMPT
    C = max(8, min(int(np.ceil(1.25 * T * K / E)), T))
    total, _ = cfg.param_count()
    params = 2 * (total + cfg.n_layers * d * E * 2 + d)   # router in fp32
    Tw = min(ctx, cfg.swa_window) if cfg.swa_window else ctx
    cache = 2 * 2 * cfg.n_layers * LM_BATCH * Tw * cfg.n_kv_heads \
        * cfg.d_head
    moe = 2 * (E * C * d + 3 * E * C * f + E * C * d + T * K * d) \
        + 4 * T * K * d
    return {"params": params, "cache": cache, "moe_layer": moe,
            "total": params + cache + moe, "capacity": C}


def _index_vs_onehot(torch, steps, MOE, cfg, tokens) -> dict:
    """``MOE.moe_fwd`` (the index route) against ``MOE.moe_fwd_onehot``
    (the reference's one-hot dispatch) on layer 0's real input, from a
    prefill of ``tokens[:1]`` in float32: max |d| <= 1e-5 max |ref|, the
    same aux, kept pairs and slots."""
    cfg = cfg.scaled(dtype="float32")
    m32 = steps.make_serve_steps(cfg)[0]
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        _, calls = _spy_moe(MOE, lambda: m32.prefill(
            p32, {"tokens": tokens[:1]}, m32.make_cache(1, LM_PROMPT)))
        p0, x0 = calls[0][0], calls[0][1]
        del calls
        y, aux = MOE.moe_fwd(p0, cfg, x0)
        y1, aux1 = MOE.moe_fwd_onehot(p0, cfg, x0)
        r = MOE.route(p0, cfg, x0.reshape(-1, cfg.d_model))
        oh = MOE.onehot_slots(r.gate_idx, cfg.n_experts, r.capacity)
        keep1, slot1 = oh.sum((2, 3)) > 0, oh.sum(2).argmax(-1)
    torch.cuda.synchronize()
    res = {"B": 1, "S": LM_PROMPT, "capacity": r.capacity,
           "onehot_bytes": oh.numel() * oh.element_size(),
           "max_abs_err": float((y - y1).abs().max()),
           "max_abs_ref": float(y1.abs().max()),
           "aux_abs_err": float((aux - aux1).abs()),
           "kept_pairs": int(r.keep.sum()),
           "dropped_pairs": int((~r.keep).sum()),
           "kept_sets_equal": bool(torch.equal(r.keep, keep1)),
           "slots_equal": bool(torch.equal(r.slot[r.keep],
                                           slot1[r.keep]))}
    if (res["max_abs_err"] > 1e-5 * res["max_abs_ref"]
            or res["aux_abs_err"] > 1e-6 or not res["kept_sets_equal"]
            or not res["slots_equal"]):
        raise AssertionError(f"index route != one-hot: {res}")
    del p32, p0, x0, y, y1, r, oh
    torch.cuda.empty_cache()
    return res


def phase_lm_serve_moe(torch, fa, kv, flash_ref, steps, L, MOE, ARCHS,
                       keep=None, routes=None):
    """MoE serving through ``make_serve_steps`` on the card:
    deepseek-moe-16b at full width and depth (``_serve``: one prefill, one
    ``flash_attention_sm90`` launch a layer, MOE_DECODE greedy steps,
    each prefill layer's dropped share; the init's peak beside
    ``param_count`` x 2); ``_index_vs_onehot`` on layer 0's real input;
    ``_fp32_checks`` at MOE_CHECK_LAYERS layers, at capacity factor E/K
    (C = T, nothing dropped: a forward over S+1 tokens is another batch,
    which at 1.25 would drop other pairs than prefill and decode do); then
    mixtral-8x7b at full width and MIXTRAL_LAYERS of its 32 layers (what
    one card holds), whose window (4096) covers the prompt, so its prefill
    launches one ``flash_attention_sm90`` a layer, and MIXTRAL_DECODE
    steps. With a list ``keep``, deepseek's prefill logits are appended
    to it, with a list ``routes`` each of its layers' route in that
    prefill. Returns deepseek's launches of the two flash kernels and
    mixtral's of ``flash_attention_sm90``."""
    cfg = ARCHS[MOE_ARCH]
    tokens, deepseek = _serve(torch, fa, kv, steps, cfg, MOE_SEED,
                              MOE_DECODE, MOE_CTX,
                              {"flash_attention_sm90": cfg.n_layers}, MOE,
                              keep=keep, routes=routes)
    onehot = _index_vs_onehot(torch, steps, MOE, cfg.scaled(
        n_layers=MOE_CHECK_LAYERS), tokens)
    cfg2 = cfg.scaled(n_layers=MOE_CHECK_LAYERS)
    with _no_drops(MOE, cfg2):
        checks = _fp32_checks(torch, fa, flash_ref, steps, L, cfg2, tokens,
                              MOE_CTX)
    mcfg = ARCHS[MIXTRAL_ARCH].scaled(n_layers=MIXTRAL_LAYERS)
    _, mixtral = _serve(torch, fa, kv, steps, mcfg, 6, MIXTRAL_DECODE,
                        LM_PROMPT + MIXTRAL_DECODE,
                        {"flash_attention_sm90": mcfg.n_layers}, MOE)
    for c, res in ((cfg, deepseek), (mcfg, mixtral)):
        res.update(param_count=list(c.param_count()),
                   param_count_x2_bytes=2 * c.param_count()[0],
                   memory_reckoning_bytes=_moe_reckoning(c, res["ctx"]))
    launches = deepseek["launches_per_run"]["flash_attention_sm90"]
    emit({"phase": "lm_serve_moe", **deepseek,
          "flash_attention_sm90_launches_per_prefill": launches,
          "index_route_vs_onehot": onehot,
          "fp32_check_layers": MOE_CHECK_LAYERS,
          "fp32_check_capacity": "C = T (factor E/K)", **checks,
          "mixtral": {**mixtral,
                      "layers_of": ARCHS[MIXTRAL_ARCH].n_layers}})
    return (launches, checks["fp32_flash_attention_simt_launches_per_prefill"],
            mixtral["launches_per_run"]["flash_attention_sm90"])


SSM_ARCH, SSM_DECODE = "zamba2-7b", 16
SSM_CTX = LM_PROMPT + 32
SSM_CHECK_LAYERS = 9      # one group of 6 and the tail of 3
XLSTM_ARCH, XLSTM_DECODE = "xlstm-125m", 32


def _ssm_reckoning(cfg, ctx, n_params) -> dict:
    """Bytes of zamba2's bf16 serving state, from the shapes: the
    parameters (the fp32 A_log, D and dt_bias among them), the shared
    attention's K/V cache and the fp32 SSM states."""
    H = 2 * cfg.d_model // cfg.ssm_headdim
    n_attn = cfg.n_layers // cfg.attn_every
    params = 2 * n_params + 2 * 3 * H * cfg.n_layers
    Tw = min(ctx, 4096)                 # transformer.ZAMBA_WINDOW
    cache = 2 * 2 * n_attn * LM_BATCH * Tw * cfg.n_kv_heads * cfg.d_head
    ssm = 4 * cfg.n_layers * LM_BATCH * H * cfg.ssm_state * cfg.ssm_headdim
    return {"params": params, "attention_cache": cache, "ssm_state": ssm,
            "total": params + cache + ssm}


def phase_lm_serve_ssm(torch, fa, kv, flash_ref, steps, L, ARCHS, smi):
    """The SSM stacks through ``make_serve_steps`` on the card: zamba2-7b
    at full width and all 81 layers (``_serve``: one prefill, whose
    shared attention is one ``flash_attention_sm90`` launch a group, 13
    in bf16 at dh 112, and SSM_DECODE greedy steps; one timed prefill, the
    scan being slow; the init's peak beside ``param_count`` x 2), then
    ``_fp32_checks`` at SSM_CHECK_LAYERS layers (one group, one launch);
    then xlstm-125m whole, which launches no kernel, XLSTM_DECODE steps,
    and its float32 checks. Returns the launches of
    ``flash_attention_sm90`` on the bf16 path and of
    ``flash_attention_simt`` in the float32 check."""
    cfg = ARCHS[SSM_ARCH]
    n_attn = cfg.n_layers // cfg.attn_every
    tokens, zamba = _serve(torch, fa, kv, steps, cfg, 8, SSM_DECODE, SSM_CTX,
                           {"flash_attention_sm90": n_attn}, repeats=1)
    ccfg = cfg.scaled(n_layers=SSM_CHECK_LAYERS)
    checks = _fp32_checks(torch, fa, flash_ref, steps, L, ccfg, tokens,
                          SSM_CTX, want=SSM_CHECK_LAYERS // cfg.attn_every)
    xcfg = ARCHS[XLSTM_ARCH]
    xtokens, xlstm = _serve(torch, fa, kv, steps, xcfg, 10, XLSTM_DECODE,
                            LM_PROMPT + XLSTM_DECODE, {}, repeats=1)
    xchecks = _fp32_checks(torch, fa, flash_ref, steps, L, xcfg, xtokens,
                           LM_PROMPT + XLSTM_DECODE, want=0)
    for c, res in ((cfg, zamba), (xcfg, xlstm)):
        res.update(param_count=list(c.param_count()),
                   param_count_x2_bytes=2 * c.param_count()[0])
    zamba["memory_reckoning_bytes"] = _ssm_reckoning(cfg, SSM_CTX,
                                                     zamba["params"])
    launches = zamba["launches_per_run"]["flash_attention_sm90"]
    emit({"phase": "lm_serve_ssm", "card": smi, **zamba,
          "flash_attention_sm90_launches_per_prefill": launches,
          "attention_d_head": cfg.d_head,
          "fp32_check_layers": SSM_CHECK_LAYERS, **checks,
          "xlstm": {**xlstm, **xchecks}})
    return launches, checks["fp32_flash_attention_simt_launches_per_prefill"]


ENCDEC_ARCH, ENCDEC_S, ENCDEC_DECODE = "whisper-medium", 224, 32
# whisper's text context: n_text_ctx in the model dimensions that
# openai/whisper's model.py publishes for every size
ENCDEC_CTX = 448
VLM_ARCH, VLM_LAYERS, VLM_DECODE = "qwen2-vl-72b", 24, 8
VLM_PATCHES = 256          # the reference's input_specs
VLM_CTX = VLM_PATCHES + LM_PROMPT + 32
VLM_CHECK_LAYERS = 2      # the float32 checks, as lm_serve_moe's


def _frontend(torch, profile_serve, cfg, seed):
    """``profile_serve.frontend_inputs`` (whisper's frames or qwen2-vl's
    patches, x0.02 from a numpy seed) as float32 on the card; the model
    casts them to its dtype."""
    return {k: torch.from_numpy(v).cuda() for k, v in
            profile_serve.frontend_inputs(
                cfg, LM_BATCH, np.random.default_rng(seed)).items()}


def _spy_flash(L):
    """A patch of ``L.flash_attention`` recording (q's shape, k's shape,
    causal) of each call."""
    from unittest import mock
    calls, inner = [], L.flash_attention

    def spy(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return inner(q, k, v, causal)

    return calls, mock.patch.object(L, "flash_attention", spy)


def _check_flash_calls(calls, want, runs, tag):
    """``calls`` (``_spy_flash``'s over ``runs`` prefills) are ``want``,
    the calls of one prefill, in order, ``runs`` times over."""
    if calls != want * runs:
        raise AssertionError(f"{tag}: flash_attention calls {calls[:4]}... "
                             f"({len(calls)}), not {want[:1]}... "
                             f"({len(want)} a prefill) x {runs}")


def phase_lm_serve_encdec(torch, fa, kv, flash_ref, steps, L, ARCHS, smi,
                          profile_serve):
    """whisper-medium at full width and all 48 layers through
    ``make_serve_steps`` on the card (``_serve``: LM_BATCH prompts of
    ENCDEC_S tokens over 1500 frames, a cache for ENCDEC_CTX; one
    prefill and ENCDEC_DECODE greedy steps, which launch 48
    ``flash_attention_sm90`` and nothing else: the encoder's 24 non-causal
    at BH 64, S 1500, dh 64, then the decoder's 24 causal at S 224; 3
    timed prefills and the decode loop again), then ``_fp32_checks`` at
    full depth (48 ``flash_attention_simt`` launches a prefill). Returns
    the two kernels' launches."""
    cfg = ARCHS[ENCDEC_ARCH]
    frames = _frontend(torch, profile_serve, cfg, 12)
    BH, dh = LM_BATCH * cfg.n_heads, cfg.d_head
    enc = ((BH, cfg.n_frames, dh),) * 2 + (False,)
    dec = ((BH, ENCDEC_S, dh),) * 2 + (True,)
    calls, spy = _spy_flash(L)
    n_attn = cfg.n_enc_layers + cfg.n_layers
    with spy:
        tokens, res = _serve(torch, fa, kv, steps, cfg, 12, ENCDEC_DECODE,
                             ENCDEC_CTX, {"flash_attention_sm90": n_attn},
                             S=ENCDEC_S, extra=frames)
    _check_flash_calls(calls, [enc] * cfg.n_enc_layers + [dec] * cfg.n_layers,
                       1 + len(res["prefill_s"]), cfg.name)
    checks = _fp32_checks(torch, fa, flash_ref, steps, L, cfg, tokens,
                          ENCDEC_CTX, want=n_attn, extra=frames)
    total, _ = cfg.param_count()
    n_self = cfg.n_layers * LM_BATCH * ENCDEC_CTX * cfg.n_kv_heads * dh
    reckoning = {"params": 2 * total, "self_attention_cache": 2 * 2 * n_self,
                 "enc_out": 2 * LM_BATCH * cfg.n_frames * cfg.d_model}
    reckoning["total"] = sum(reckoning.values())
    launches = res["launches_per_run"]["flash_attention_sm90"]
    emit({"phase": "lm_serve_encdec", "card": smi, **res,
          "n_enc_layers": cfg.n_enc_layers, "n_frames": cfg.n_frames,
          "encoder_frames_per_s": [LM_BATCH * cfg.n_frames / t
                                   for t in res["prefill_s"]],
          "param_count": list(cfg.param_count()),
          "param_count_x2_bytes": 2 * total,
          "memory_reckoning_bytes": reckoning,
          "flash_attention_sm90_launches_per_prefill": launches,
          "flash_calls_per_prefill": {
              "encoder": {"q": enc[0], "k": enc[1], "causal": enc[2],
                          "n": cfg.n_enc_layers},
              "decoder": {"q": dec[0], "k": dec[1], "causal": dec[2],
                          "n": cfg.n_layers}},
          "fp32_check_layers": n_attn, **checks})
    return launches, checks["fp32_flash_attention_simt_launches_per_prefill"]


def phase_lm_serve_vlm(torch, fa, kv, flash_ref, steps, L, ARCHS, smi,
                       profile_serve):
    """qwen2-vl-72b at full width and VLM_LAYERS of its 80 layers (what
    one card holds in bf16) through ``make_serve_steps`` (``_serve``:
    LM_BATCH prompts of 256 patches and LM_PROMPT tokens, a cache for
    VLM_CTX, VLM_DECODE greedy steps from position 256 + S; one
    ``flash_attention_sm90`` launch a layer, causal, BH 256 over BHkv 32
    (G 8), S 2304, dh 128), then ``_fp32_checks`` at VLM_CHECK_LAYERS
    layers. Returns the two kernels' launches."""
    full = ARCHS[VLM_ARCH]
    cfg = full.scaled(n_layers=VLM_LAYERS)
    patches = _frontend(torch, profile_serve, cfg, 14)
    n = VLM_PATCHES + LM_PROMPT
    call = ((LM_BATCH * cfg.n_heads, n, cfg.d_head),
            (LM_BATCH * cfg.n_kv_heads, n, cfg.d_head), True)
    calls, spy = _spy_flash(L)
    with spy:
        tokens, res = _serve(torch, fa, kv, steps, cfg, 14, VLM_DECODE,
                             VLM_CTX, {"flash_attention_sm90": cfg.n_layers},
                             extra=patches)
    _check_flash_calls(calls, [call] * cfg.n_layers,
                       1 + len(res["prefill_s"]), cfg.name)
    checks = _fp32_checks(torch, fa, flash_ref, steps, L,
                          cfg.scaled(n_layers=VLM_CHECK_LAYERS), tokens,
                          VLM_CTX, extra=patches)
    total, _ = cfg.param_count()
    cache = 2 * 2 * cfg.n_layers * LM_BATCH * VLM_CTX * cfg.n_kv_heads \
        * cfg.d_head
    launches = res["launches_per_run"]["flash_attention_sm90"]
    emit({"phase": "lm_serve_vlm", "card": smi, **res,
          "layers_of": full.n_layers, "patches": VLM_PATCHES,
          "prefill_positions_per_s": [LM_BATCH * n / t
                                      for t in res["prefill_s"]],
          "param_count": list(cfg.param_count()),
          "param_count_x2_bytes": 2 * total,
          "full_depth_param_count_x2_bytes": 2 * full.param_count()[0],
          "memory_reckoning_bytes": {"params": 2 * total, "cache": cache,
                                     "total": 2 * total + cache},
          "flash_attention_sm90_launches_per_prefill": launches,
          "flash_call": {"q": call[0], "k": call[1], "causal": call[2],
                         "G": cfg.n_heads // cfg.n_kv_heads},
          "fp32_check_layers": VLM_CHECK_LAYERS, **checks})
    return launches, checks["fp32_flash_attention_simt_launches_per_prefill"]


TRAIN_B, TRAIN_S, TRAIN_TIMED = 4, 2048, 3
CHECK_LAYERS, CHECK_B, CHECK_S = 2, 2, 512   # the float32 checks


def _batch(torch, pipe, i):
    return {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(i).items()}


def _spied_step(torch, steps, adamw, step, params, opt, batch):
    """One ``train_step``, with the gradients it hands ``adamw.apply``."""
    from unittest import mock
    seen, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        seen.append(g)
        return apply(p, g, o, **kw)

    with mock.patch.object(steps.adamw, "apply", spy):
        out = step(params, opt, batch)
    return out, seen[0]


def _check_grads(torch, adamw, grads, tag):
    """Every leaf has a finite gradient that is not all zero."""
    for i, g in enumerate(adamw.leaves(grads)):
        if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            raise AssertionError(f"{tag}: leaf {i} {tuple(g.shape)} has a "
                                 "zero or non-finite gradient")


def _named(tree, prefix=""):
    """(path, leaf) over nested dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _unmoved(torch, before, after):
    """The paths of the leaves in which no element changed."""
    return [p for (p, a), (_, b) in zip(_named(before), _named(after))
            if torch.equal(a, b)]


def _counted(fa, kv, fn, want, tag):
    """``fn()``, which must launch the flash kernels ``want`` times each
    and no Vcycle kernel."""
    fa.reset_counts()
    kv.reset_counts()
    out = fn()
    if dict(fa.COUNTS) != want or any(kv.COUNTS.values()):
        raise AssertionError(f"{tag}: launched {dict(fa.COUNTS)} (not "
                             f"{want}), Vcycle kernels {kv.COUNTS}")
    return out


def _loss_grads(torch, adamw, model, params, batch):
    """(loss, gradients) of ``model.loss`` by ``backward()``: what a
    ``make_train_step`` step hands AdamW, without AdamW's new state."""
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss(leaves, batch)
    loss.backward()
    return float(loss.detach()), adamw.tree_map(lambda p: p.grad, leaves)


def _grad_err(torch, adamw, got, want) -> float:
    """max |got - want| over each leaf's max |want|, the worst leaf."""
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(adamw.leaves(got), adamw.leaves(want)))


def _train_reckoning(adamw, p_shapes) -> dict:
    """Bytes a bf16 step holds at its high point, from the shapes: the
    caller's params and moments, the gradients, and AdamW's new params
    and moments (fp32 m and v a parameter)."""
    n = sum(t.numel() for t in adamw.leaves(p_shapes))
    p = sum(t.numel() * t.element_size() for t in adamw.leaves(p_shapes))
    out = {"params": p, "grads": p, "adam_m_and_v": 8 * n,
           "new_params_and_moments": p + 8 * n}
    out["total"] = sum(out.values())
    return out


def _train_model(torch, fa, kv, steps, adamw, cfg, batch_at, want, n_timed,
                 tag):
    """``make_train_step(cfg)`` on the card in the config's bf16, weights
    random from a seed: step 1 (the warm-up) with its gradients, every
    leaf's finite and nonzero and every leaf but the norm scales moved
    (step 1's lr is 3e-6: a scale of 1.0 cannot move in bf16), then
    ``n_timed`` steps timed to a synchronize; each step launches the
    flash kernels ``want`` times (``_counted``). Returns the run's
    numbers."""
    model, step, p_shapes, _ = steps.make_train_step(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch = batch_at(0)
    t0 = time.perf_counter()
    (new, opt, metrics), grads = _counted(fa, kv, lambda: _spied_step(
        torch, steps, adamw, step, params, opt, batch), want, f"{tag} step 1")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _check_grads(torch, adamw, grads, f"{tag} bf16 step 1")
    unmoved = _unmoved(torch, params, new)
    if any(not p.endswith("/scale") for p in unmoved):
        raise AssertionError(f"{tag} step 1: leaves did not move: {unmoved}")
    n_leaves = len(list(adamw.leaves(params)))
    del grads, params
    params = new
    losses, gnorms = [float(metrics["loss"])], [float(metrics["gnorm"])]
    step_s = []
    for i in range(1, 1 + n_timed):
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = _counted(
            fa, kv, lambda: step(params, opt, batch), want,
            f"{tag} step {i + 1}")
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses + gnorms)) or min(gnorms) <= 0:
        raise AssertionError(f"{tag}: loss {losses}, gnorm {gnorms}")
    del params, opt, metrics, batch, new
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "params": sum(t.numel() for t in adamw.leaves(p_shapes)),
            "leaves": n_leaves, "leaves_not_moved_at_step_1": unmoved,
            "launches_per_step": want, "first_step_s": first_s,
            "step_s": step_s, "loss": losses, "gnorm": gnorms,
            "peak_memory_bytes": peak,
            "memory_reckoning_bytes": _train_reckoning(adamw, p_shapes)}


def phase_lm_train(torch, fa, kv, flash_ref, steps, L, ARCHS, adamw,
                   TokenPipeline, PipelineConfig, CheckpointManager):
    """qwen3-0.6b at full width trained through ``make_train_step`` in the
    config's bf16 on ``TokenPipeline(PipelineConfig(vocab, TRAIN_S,
    TRAIN_B)).batch_at(i)``: one warm-up step, then TRAIN_TIMED steps
    timed to a synchronize. Every step must launch 2 x 28
    ``flash_attention_sm90`` (the forward and its recompute under
    ``torch.utils.checkpoint``, which saves lse) and 28
    ``flash_attention_bwd_sm90``, no ``flash_attention_bwd`` and no
    Vcycle kernel. Checks: loss and gnorm finite, gnorm > 0, every leaf's
    gradient finite and nonzero at step 1 (a leaf the loss cannot reach
    raises in the step), and each weight matrix moved. Then at full width
    with CHECK_LAYERS layers in float32 (CHECK_B x CHECK_S tokens): one
    step's gradients on the kernels (``flash_attention_simt`` and
    ``flash_attention_bwd``) against the same step on ``flash_ref`` under
    autograd, within 1e-4 of each leaf's max, every leaf moved; and 2
    steps, a ``CheckpointManager`` save and restore into fresh tensors,
    then 1 step, bit-equal to 3 uninterrupted steps. Returns the bf16
    run's launches of each flash kernel, and the counted float32 step's."""
    from unittest import mock
    cfg = ARCHS[LM_ARCH]
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, TRAIN_S, TRAIN_B))
    want = {"flash_attention_sm90": 2 * cfg.n_layers,
            "flash_attention_simt": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_sm90": cfg.n_layers}
    res = _train_model(torch, fa, kv, steps, adamw, cfg,
                       lambda i: _batch(torch, pipe, i), want, TRAIN_TIMED,
                       "train")
    launches = {k: v * (1 + TRAIN_TIMED) for k, v in want.items()}

    # float32 at full width, CHECK_LAYERS layers
    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    m32, step32, _, _ = steps.make_train_step(cfg32)
    p0 = m32.init(torch.Generator(device="cuda").manual_seed(1))
    o0 = adamw.init(p0)
    pipe32 = TokenPipeline(PipelineConfig(cfg.vocab, CHECK_S, CHECK_B))
    b0 = _batch(torch, pipe32, 0)
    want32 = {"flash_attention_sm90": 0,
              "flash_attention_simt": 2 * CHECK_LAYERS,
              "flash_attention_bwd": CHECK_LAYERS,
              "flash_attention_bwd_sm90": 0}
    (pk, _, mk), gk = _counted(fa, kv, lambda: _spied_step(
        torch, steps, adamw, step32, p0, o0, b0), want32, "float32 step")
    with mock.patch.object(L, "flash_attention", flash_ref):
        (pp, _, mp), gp = _spied_step(torch, steps, adamw, step32, p0, o0,
                                      b0)
    grad_err = _grad_err(torch, adamw, gk, gp)
    if not grad_err <= 1e-4:
        raise AssertionError(f"float32 step: kernel gradients != flash_ref "
                             f"under autograd ({grad_err} of a leaf's max)")
    _check_grads(torch, adamw, gk, "float32 step")
    if _unmoved(torch, p0, pk):
        raise AssertionError(f"float32 step: leaves did not move: "
                             f"{_unmoved(torch, p0, pk)}")
    loss_err = abs(float(mk["loss"]) - float(mp["loss"]))
    del pk, pp, gk, gp
    # resume: 3 steps against 2, a checkpoint, a restore and 1
    p, o = p0, o0
    for i in range(3):
        p, o, _ = step32(p, o, _batch(torch, pipe32, i))
    straight = {"params": p, "opt": o}
    p, o = p0, o0
    for i in range(2):
        p, o, _ = step32(p, o, _batch(torch, pipe32, i))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(2, {"params": p, "opt": o}, blocking=True)
        fresh = {"params": adamw.tree_map(torch.zeros_like, p),
                 "opt": adamw.init(p)}
        at, restored = mgr.restore_tree(fresh)
    p, o, _ = step32(restored["params"], restored["opt"],
                     _batch(torch, pipe32, 2))
    pairs = [(a, b) for x, y in ((p, straight["params"]),
                                 (o.m, straight["opt"].m),
                                 (o.v, straight["opt"].v))
             for a, b in zip(adamw.leaves(x), adamw.leaves(y))]
    pairs.append((o.step, straight["opt"].step))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    n_pairs = len(pairs)
    if at != 2 or differ:
        raise AssertionError(f"resume: {differ} of {len(pairs)} leaves "
                             "differ from 3 uninterrupted steps (restored "
                             f"step {at})")
    del p, o, p0, o0, straight, restored, pairs
    torch.cuda.empty_cache()
    ntok = TRAIN_B * TRAIN_S
    # what the step holds at once, from the shapes, against the peak
    param_bytes = res["memory_reckoning_bytes"]["params"]
    reckoning = {"params": param_bytes, "grads": param_bytes,
                 "adam_m_and_v": 8 * res["params"],
                 "fp32_logits": 4 * ntok * cfg.vocab,
                 "fp32_logits_grad": 4 * ntok * cfg.vocab}
    emit({"phase": "lm_train", "arch": LM_ARCH,
          "call": f"repro_torch.launch.steps.make_train_step(ARCHS"
                  f"['{LM_ARCH}'])", **res, "vocab": cfg.vocab,
          "B": TRAIN_B, "S": TRAIN_S, "tokens_per_step": ntok,
          "tokens_per_s": [ntok / t for t in res["step_s"]],
          "memory_reckoning_bytes": reckoning,
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "launches": want32,
                         "grad_err_over_leaf_max": grad_err,
                         "loss_abs_err": loss_err,
                         "resume_bit_equal_leaves": n_pairs}})
    return launches, want32


ENCDEC_TRAIN_TIMED = 3      # lm_train_encdec's timed steps
ENCDEC_CHECK_LAYERS = 2     # its float32 check: 2 encoder + 2 decoder
SSM_TRAIN_TIMED = 1         # lm_train_ssm's timed steps a model


def _fp32_train_check(torch, fa, kv, flash_ref, steps, L, adamw, cfg32,
                      batch, want32, tag):
    """``cfg32`` (float32, full width) on the card, weights random from a
    seed: the step's gradients (``Model.loss``'s backward) with its
    attention on the kernels (``want32`` launches) against the same on
    ``flash_ref`` under autograd, within 1e-4 of each leaf's max, every
    leaf's finite and nonzero. Returns the check's numbers."""
    from unittest import mock
    model = steps.make_train_step(cfg32)[0]
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    loss_k, gk = _counted(fa, kv, lambda: _loss_grads(
        torch, adamw, model, params, batch), want32, f"{tag} float32")
    _check_grads(torch, adamw, gk, f"{tag} float32")
    with mock.patch.object(L, "flash_attention", flash_ref):
        loss_p, gp = _loss_grads(torch, adamw, model, params, batch)
    err = _grad_err(torch, adamw, gk, gp)
    if not err <= 1e-4:
        raise AssertionError(f"{tag} float32: kernel gradients != flash_ref "
                             f"under autograd ({err} of a leaf's max)")
    del params, gk, gp
    torch.cuda.empty_cache()
    return {"n_layers": cfg32.n_layers, "n_enc_layers": cfg32.n_enc_layers,
            "launches": want32, "grad_err_over_leaf_max": err,
            "loss_abs_err": abs(loss_k - loss_p)}


def phase_lm_train_encdec(torch, fa, kv, flash_ref, steps, L, ARCHS, adamw,
                          TokenPipeline, PipelineConfig, smi, profile_serve):
    """whisper-medium whole (24 + 24 layers) trained through
    ``make_train_step`` on the card in bf16: LM_BATCH x ENCDEC_S tokens
    and labels from ``TokenPipeline`` over ``_frontend``'s 1500 frames
    (``lm_serve_encdec``'s shape), a warm-up and ENCDEC_TRAIN_TIMED timed
    steps (``_train_model``). Each step launches 96
    ``flash_attention_sm90`` (the forward and its recompute under each
    layer's checkpoint: 24 not causal at BH 64, S 1500, dh 64 and 24
    causal at S 224, twice; read by a spy on ``layers.flash_attention``)
    and 48 ``flash_attention_bwd_sm90``, nothing else; the
    cross-attention's backward is ``_sdpa``'s under autograd. Then at
    full width with ENCDEC_CHECK_LAYERS + ENCDEC_CHECK_LAYERS layers in
    float32 (CHECK_B rows) ``_fp32_train_check``. Returns the bf16 run's
    launches of each flash kernel and the float32 check's."""
    cfg = ARCHS[ENCDEC_ARCH]
    frames = _frontend(torch, profile_serve, cfg, 16)["frames"]
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, ENCDEC_S, LM_BATCH))
    n = cfg.n_enc_layers + cfg.n_layers
    want = {"flash_attention_sm90": 2 * n, "flash_attention_simt": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_sm90": n}
    BH, dh = LM_BATCH * cfg.n_heads, cfg.d_head
    enc = ((BH, cfg.n_frames, dh),) * 2 + (False,)
    dec = ((BH, ENCDEC_S, dh),) * 2 + (True,)
    calls, spy = _spy_flash(L)
    with spy:
        res = _train_model(
            torch, fa, kv, steps, adamw, cfg,
            lambda i: {**_batch(torch, pipe, i), "frames": frames}, want,
            ENCDEC_TRAIN_TIMED, "lm_train_encdec")
    runs = 1 + ENCDEC_TRAIN_TIMED
    if (calls.count(enc) != 2 * cfg.n_enc_layers * runs
            or calls.count(dec) != 2 * cfg.n_layers * runs
            or len(calls) != 2 * n * runs):
        raise AssertionError(f"lm_train_encdec: flash_attention calls "
                             f"{calls[:4]}... ({len(calls)})")
    cfg32 = cfg.scaled(n_layers=ENCDEC_CHECK_LAYERS,
                       n_enc_layers=ENCDEC_CHECK_LAYERS, dtype="float32")
    pipe32 = TokenPipeline(PipelineConfig(cfg.vocab, ENCDEC_S, CHECK_B))
    n32 = 2 * ENCDEC_CHECK_LAYERS
    want32 = {"flash_attention_sm90": 0, "flash_attention_simt": 2 * n32,
              "flash_attention_bwd": n32, "flash_attention_bwd_sm90": 0}
    check = _fp32_train_check(
        torch, fa, kv, flash_ref, steps, L, adamw, cfg32,
        {**_batch(torch, pipe32, 0), "frames": frames[:CHECK_B]}, want32,
        "lm_train_encdec")
    del frames
    ntok = LM_BATCH * ENCDEC_S
    emit({"phase": "lm_train_encdec", "card": smi,
          "call": f"repro_torch.launch.steps.make_train_step(ARCHS"
                  f"['{ENCDEC_ARCH}'])", **res,
          "n_enc_layers": cfg.n_enc_layers, "n_frames": cfg.n_frames,
          "B": LM_BATCH, "S": ENCDEC_S, "tokens_per_step": ntok,
          "tokens_per_s": [ntok / t for t in res["step_s"]],
          "frames_per_s": [LM_BATCH * cfg.n_frames / t
                           for t in res["step_s"]],
          "flash_calls_per_step": {
              "encoder": {"q": enc[0], "causal": False,
                          "n": 2 * cfg.n_enc_layers},
              "decoder": {"q": dec[0], "causal": True,
                          "n": 2 * cfg.n_layers}},
          "fp32_check": {**check, "B": CHECK_B, "S": ENCDEC_S}})
    return ({k: v * runs for k, v in want.items()}, want32)


def phase_lm_train_ssm(torch, fa, kv, flash_ref, steps, L, ARCHS, adamw,
                       TokenPipeline, PipelineConfig, smi):
    """The recurrent stacks trained through ``make_train_step`` on the card
    in bf16 on TRAIN_B x TRAIN_S tokens from ``TokenPipeline`` (a warm-up
    and SSM_TRAIN_TIMED timed steps each, ``_train_model``; each layer
    checkpointed, each scan in checkpointed chunks of ``SCAN_CHUNK``
    steps): xlstm-125m whole, which launches no flash kernel, then
    zamba2-7b at full width and SSM_CHECK_LAYERS of its 81 layers (one
    group of six with its shared attention, and a three-layer tail: every
    kind of leaf), whose shared attention (bf16 at dh 112, S 2048 under
    its 4096 window) launches ``flash_attention_sm90`` twice a group (the
    forward and its recompute) and ``flash_attention_bwd_sm90`` once. Then
    zamba2's float32 check at the same depth (CHECK_B x CHECK_S,
    ``_fp32_train_check``). Returns the bf16 runs' launches of each flash
    kernel and the float32 check's."""
    from repro_torch.models import ssm as SSM
    pipe = TokenPipeline(PipelineConfig(ARCHS[XLSTM_ARCH].vocab, TRAIN_S,
                                        TRAIN_B))
    none = {"flash_attention_sm90": 0, "flash_attention_simt": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0}
    xlstm = _train_model(torch, fa, kv, steps, adamw, ARCHS[XLSTM_ARCH],
                         lambda i: _batch(torch, pipe, i), none,
                         SSM_TRAIN_TIMED, "lm_train_ssm xlstm")
    full = ARCHS[SSM_ARCH]
    cfg = full.scaled(n_layers=SSM_CHECK_LAYERS)
    groups = cfg.n_layers // cfg.attn_every
    want = {**none, "flash_attention_sm90": 2 * groups,
            "flash_attention_bwd_sm90": groups}
    call = ((TRAIN_B * cfg.n_heads, TRAIN_S, cfg.d_head),) * 2 + (True,)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, TRAIN_S, TRAIN_B))
    calls, spy = _spy_flash(L)
    with spy:
        zamba = _train_model(torch, fa, kv, steps, adamw, cfg,
                             lambda i: _batch(torch, pipe, i), want,
                             SSM_TRAIN_TIMED, "lm_train_ssm zamba2")
    runs = 1 + SSM_TRAIN_TIMED
    if calls != [call] * 2 * groups * runs:
        raise AssertionError(f"lm_train_ssm zamba2: flash_attention calls "
                             f"{calls[:4]}... ({len(calls)})")
    want32 = {**none, "flash_attention_simt": 2 * groups,
              "flash_attention_bwd": groups}
    pipe32 = TokenPipeline(PipelineConfig(cfg.vocab, CHECK_S, CHECK_B))
    check = _fp32_train_check(torch, fa, kv, flash_ref, steps, L, adamw,
                              cfg.scaled(dtype="float32"),
                              _batch(torch, pipe32, 0), want32,
                              "lm_train_ssm zamba2")
    ntok = TRAIN_B * TRAIN_S
    for res in (xlstm, zamba):
        res["tokens_per_s"] = [ntok / t for t in res["step_s"]]
    zamba.update(layers_of=full.n_layers, groups=groups,
                 tail=cfg.n_layers % cfg.attn_every,
                 flash_call={"q": call[0], "causal": True},
                 fp32_check={**check, "B": CHECK_B, "S": CHECK_S})
    emit({"phase": "lm_train_ssm", "card": smi,
          "call": "repro_torch.launch.steps.make_train_step(cfg)",
          "B": TRAIN_B, "S": TRAIN_S, "tokens_per_step": ntok,
          "scan_chunk": SSM.SCAN_CHUNK, "xlstm": xlstm, "zamba2": zamba})
    return ({k: v * runs for k, v in want.items()}, want32)


DP_SHARDS = 4               # lm_train_dp's and lm_serve_dp's data shards
DP_CHECK_SHARDS = 2         # their float32 checks' (CHECK_B = 2 rows)
DP_LOSS_TOL = FLASH_TOL["bfloat16"]   # bf16 step loss, of its size


def _peak(torch, devices):
    """max_memory_allocated of each card the devices name."""
    return {str(d): torch.cuda.max_memory_allocated(d)
            for d in sorted({str(d) for d in devices})}


def _reset_peak(torch, devices):
    _sync_all(torch)
    for d in {str(d) for d in devices}:
        torch.cuda.reset_peak_memory_stats(d)


def _replicas_differ(torch, SH, replicas) -> int:
    """Leaves of replicas 1.. that are not bit-equal to replica 0's."""
    first = SH.tree_leaves(replicas[0])
    return sum(not torch.equal(a, b.to(a.device))
               for r in replicas[1:]
               for a, b in zip(first, SH.tree_leaves(r)))


def _timed_reduce(torch, OV, red):
    """``OV.bucketed_mean`` between two CUDA events on shard 0's card,
    appended to ``red``: the reduction's device time, with no sync."""
    from unittest import mock
    inner = OV.bucketed_mean

    def timed(*a, **kw):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = inner(*a, **kw)
        t1.record()
        red.append((t0, t1))
        return out

    return mock.patch.object(OV, "bucketed_mean", timed)


def phase_lm_train_dp(torch, fa, kv, steps, ARCHS, adamw, TokenPipeline,
                      PipelineConfig, SH, OV, make_host_mesh, place=one_card):
    """qwen3-0.6b at full width, data-parallel over DP_SHARDS shards
    (``place``: of card 0, or one a card) through ``make_train_step(cfg,
    mesh)``: ``lm_train``'s params (seed 0) and batches, replicated, one
    warm-up step and TRAIN_TIMED timed ones. Each step must launch D x 56
    ``flash_attention_sm90`` and D x 28 ``flash_attention_bwd_sm90`` and
    nothing else; the replicas (params, m, v) stay bit-equal after every
    step; the first step's loss is within DP_LOSS_TOL of the one-device
    step's on the same params and batch. The reduction
    (``overlap.bucketed_mean``) is timed by CUDA events on shard 0's card.
    Then in float32 at CHECK_LAYERS layers over DP_CHECK_SHARDS shards:
    the DP step against the one-device step on the same params and
    CHECK_B x CHECK_S batch, the loss within 1e-5 of its size, every
    gradient leaf within 1e-5 of its max, the params after the step within
    1e-5 (twice step 1's lr of 3e-6 is 6e-6: Adam's first update is about
    lr x sign(g), which can flip where an element of g sits at its
    rounding level). Returns the bf16 run's launches of each kernel and
    the counted float32 DP step's."""
    cfg = ARCHS[LM_ARCH]
    devices = place(DP_SHARDS)
    mesh = make_host_mesh(devices=devices)
    D = len(devices)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, TRAIN_S, TRAIN_B))
    # the one-device step's loss on the same params and batch
    model1, step1, p_shapes, _ = steps.make_train_step(cfg, devices[0])
    params = model1.init(torch.Generator(device=devices[0]).manual_seed(0))
    batch0 = _batch(torch, pipe, 0)
    one_loss = float(step1(params, adamw.init(params), batch0)[2]["loss"])
    torch.cuda.empty_cache()

    model, step, _, _ = steps.make_train_step(cfg, mesh)
    _reset_peak(torch, devices)
    base = {str(d): torch.cuda.memory_allocated(d) for d in set(devices)}
    pr = SH.replicate(params, mesh)
    orr = SH.replicate(adamw.init(params), mesh)
    del params
    want = {"flash_attention_sm90": 2 * cfg.n_layers * D,
            "flash_attention_simt": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_sm90": cfg.n_layers * D}
    red, losses, gnorms, step_s, differ = [], [], [], [], []
    with _timed_reduce(torch, OV, red):
        for i in range(1 + TRAIN_TIMED):
            batch = batch0 if i == 0 else _batch(torch, pipe, i)
            _sync_all(torch)
            t0 = time.perf_counter()
            pr, orr, metrics = _counted(
                fa, kv, lambda: step(pr, orr, batch), want,
                f"dp train step {i + 1}")
            _sync_all(torch)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["gnorm"]))
            differ.append(_replicas_differ(torch, SH, pr)
                          + _replicas_differ(torch, SH, [o.m for o in orr])
                          + _replicas_differ(torch, SH, [o.v for o in orr]))
    peak = _peak(torch, devices)
    reduce_ms = [a.elapsed_time(b) for a, b in red]
    n_buckets = len(step.buckets)
    if any(differ):
        raise AssertionError(f"dp train: replicas differ ({differ} leaves "
                             "a step)")
    if not all(np.isfinite(losses + gnorms)) or min(gnorms) <= 0:
        raise AssertionError(f"dp train: loss {losses}, gnorm {gnorms}")
    loss_err = abs(losses[0] - one_loss)
    if not loss_err <= DP_LOSS_TOL * abs(one_loss):
        raise AssertionError(f"dp train: step 1 loss {losses[0]} vs the "
                             f"one-device step's {one_loss}")
    launches = {k: v * (1 + TRAIN_TIMED) for k, v in want.items()}
    del pr, orr, metrics, batch, batch0
    torch.cuda.empty_cache()

    # float32, CHECK_LAYERS layers, DP_CHECK_SHARDS shards vs one device
    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    dev32 = place(DP_CHECK_SHARDS)
    mesh32 = make_host_mesh(devices=dev32)
    m32, one32, _, _ = steps.make_train_step(cfg32, dev32[0])
    _, dp32, _, _ = steps.make_train_step(cfg32, mesh32)
    p0 = m32.init(torch.Generator(device=dev32[0]).manual_seed(1))
    o0 = adamw.init(p0)
    b0 = _batch(torch, TokenPipeline(PipelineConfig(
        cfg.vocab, CHECK_S, CHECK_B)), 0)
    (p1, _, m1), g1 = _spied_step(torch, steps, adamw, one32, p0, o0, b0)
    want32 = {"flash_attention_sm90": 0,
              "flash_attention_simt": 2 * CHECK_LAYERS * DP_CHECK_SHARDS,
              "flash_attention_bwd": CHECK_LAYERS * DP_CHECK_SHARDS,
              "flash_attention_bwd_sm90": 0}
    (pd, od, md), gd = _counted(fa, kv, lambda: _spied_step(
        torch, steps, adamw, dp32, SH.replicate(p0, mesh32),
        SH.replicate(o0, mesh32), b0), want32, "float32 dp step")
    grad_err = max(float((a.to(b.device) - b).abs().max())
                   / float(b.abs().max())
                   for a, b in zip(adamw.leaves(gd), adamw.leaves(g1)))
    param_err = max(float((a.to(b.device) - b).abs().max())
                    for a, b in zip(adamw.leaves(pd[0]), adamw.leaves(p1)))
    loss_err32 = abs(float(md["loss"]) - float(m1["loss"]))
    differ32 = _replicas_differ(torch, SH, pd)
    if (not grad_err <= 1e-5 or not param_err <= 1e-5
            or not loss_err32 <= 1e-5 * abs(float(m1["loss"])) or differ32):
        raise AssertionError(
            f"float32 dp step != one-device step: gradients {grad_err} of "
            f"a leaf's max, params {param_err}, loss {loss_err32}, "
            f"{differ32} replica leaves differ")
    del p0, o0, p1, g1, pd, od, gd
    torch.cuda.empty_cache()
    ntok = TRAIN_B * TRAIN_S
    n_params = sum(t.numel() for t in adamw.leaves(p_shapes))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in adamw.leaves(p_shapes))
    # what the step holds at once, from the shapes: the caller's replicas,
    # the new ones AdamW makes, the gradients, one shard's fp32 logits
    reckoning = {"replica_params": D * param_bytes,
                 "replica_adam_m_and_v": D * 8 * n_params,
                 "replica_grads": D * param_bytes,
                 "new_params_and_moments": D * (param_bytes + 8 * n_params),
                 "fp32_logits_a_shard": 4 * ntok // D * cfg.vocab,
                 "fp32_logits_grad_a_shard": 4 * ntok // D * cfg.vocab}
    emit({"phase": "lm_train_dp", "arch": LM_ARCH,
          "call": f"repro_torch.launch.steps.make_train_step(ARCHS"
                  f"['{LM_ARCH}'], make_host_mesh(devices="
                  f"{[str(d) for d in devices]}))",
          "shards": _shards_on(devices),
          "label": (f"{D} shards of one card: shards run in turn, no copies "
                    "between cards" if len(set(map(str, devices))) == 1
                    else "one shard a card: the reduction copies between "
                    "cards"),
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "params": n_params, "dtype": cfg.dtype,
          "B": TRAIN_B, "S": TRAIN_S, "tokens_per_step": ntok,
          "launches_per_step": want, "step_s": step_s,
          "tokens_per_s": [ntok / t for t in step_s],
          "loss": losses, "gnorm": gnorms,
          "one_device_step_1_loss": one_loss, "loss_abs_err": loss_err,
          "buckets": n_buckets, "bucket_bytes": 32 << 20,
          "reduce_ms": reduce_ms,
          "replica_leaves_differing_per_step": differ,
          "peak_memory_bytes": peak, "base_bytes": base,
          "memory_reckoning_bytes": {**reckoning,
                                     "total": sum(reckoning.values())},
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "shards": _shards_on(dev32),
                         "launches": want32,
                         "grad_err_over_leaf_max": grad_err,
                         "param_max_abs_err": param_err,
                         "loss_abs_err": loss_err32}})
    return launches, want32


def phase_lm_serve_dp(torch, fa, kv, steps, ARCHS, SH, make_host_mesh,
                      place=one_card):
    """qwen3-0.6b at full width served data-parallel over DP_SHARDS
    shards through ``make_serve_steps(cfg, mesh)``: ``lm_serve``'s params
    (seed 0) and LM_BATCH prompts of LM_PROMPT tokens, replicated, a cache
    for LM_CTX placed by ``cache_specs`` (``steps.shard_cache``), one
    counted prefill (a ``flash_attention_sm90`` launch a layer a shard) and
    LM_DECODE greedy steps in bf16, then a timed prefill and the decode
    loop again. In float32 at CHECK_LAYERS layers over DP_CHECK_SHARDS
    shards, on CHECK_B x CHECK_S tokens: the prefill's logits within 1e-4
    of the one-device serve's and LM_GREEDY_CHECK greedy tokens equal.
    Returns the bf16 run's ``flash_attention_sm90`` launches and the
    float32 DP prefill's ``flash_attention_simt`` launches."""
    cfg = ARCHS[LM_ARCH]
    devices = place(DP_SHARDS)
    mesh = make_host_mesh(devices=devices)
    D = len(devices)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    params = model.init(torch.Generator(device=devices[0]).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(devices[0])
    _reset_peak(torch, devices)
    pr = SH.replicate(params, mesh)
    del params
    cache = steps.shard_cache(cfg, mesh, model.make_cache(LM_BATCH, LM_CTX))
    want = {"flash_attention_sm90": cfg.n_layers * D}

    def run():
        logits, c = prefill(pr, {"tokens": tokens}, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out = [tok]
        for i in range(LM_DECODE):
            tok, c = decode(pr, tok, c, LM_PROMPT + i)
            out.append(tok)
        return logits, torch.cat(out, 1)

    _sync_all(torch)
    t0 = time.perf_counter()
    logits, gen = _counted(fa, kv, run, {
        "flash_attention_sm90": want["flash_attention_sm90"],
        "flash_attention_simt": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_sm90": 0}, "dp serve")
    _sync_all(torch)
    first_s = time.perf_counter() - t0
    if (not bool(torch.isfinite(logits).all())
            or logits.shape != (LM_BATCH, 1, cfg.vocab)
            or gen.shape != (LM_BATCH, LM_DECODE + 1)
            or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab):
        raise AssertionError("dp serving gave non-finite logits or bad "
                             "tokens")
    _, prefill_s = _synced(torch, lambda: prefill(pr, {"tokens": tokens},
                                                  cache))
    tok = gen[:, :1]

    def loop():
        t = tok
        for i in range(LM_DECODE):
            t, _ = decode(pr, t, cache, LM_PROMPT + i)

    _, decode_s = _synced(torch, loop)
    peak = _peak(torch, devices)
    del pr, cache, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    dev32 = place(DP_CHECK_SHARDS)
    mesh32 = make_host_mesh(devices=dev32)
    m1, pre1, dec1 = steps.make_serve_steps(cfg32, dev32[0])
    _, pre_dp, dec_dp = steps.make_serve_steps(cfg32, mesh32)
    p32 = m1.init(torch.Generator(device=dev32[0]).manual_seed(1))
    toks32 = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (CHECK_B, CHECK_S))).to(dev32[0])
    ctx32 = CHECK_S + LM_GREEDY_CHECK

    def greedy(pre, dec, params, cache):
        logits, cache = pre(params, {"tokens": toks32}, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out = [tok]
        for i in range(LM_GREEDY_CHECK - 1):
            tok, cache = dec(params, tok, cache, CHECK_S + i)
            out.append(tok)
        return logits, torch.cat(out, 1)

    l1, t1 = greedy(pre1, dec1, p32, m1.make_cache(CHECK_B, ctx32))
    fa.reset_counts()
    ld, td = greedy(pre_dp, dec_dp, SH.replicate(p32, mesh32),
                    steps.shard_cache(cfg32, mesh32,
                                      m1.make_cache(CHECK_B, ctx32)))
    launches32 = fa.COUNTS["flash_attention_simt"]
    err = float((ld - l1).abs().max())
    if (err > 1e-4 or not torch.equal(td, t1)
            or launches32 != CHECK_LAYERS * DP_CHECK_SHARDS):
        raise AssertionError(f"float32 dp serve != one-device serve: logits "
                             f"{err}, tokens {td.tolist()} vs {t1.tolist()}, "
                             f"{launches32} flash_attention_simt launches")
    del p32
    torch.cuda.empty_cache()
    launches = want["flash_attention_sm90"]
    emit({"phase": "lm_serve_dp", "arch": LM_ARCH,
          "call": f"repro_torch.launch.steps.make_serve_steps(ARCHS"
                  f"['{LM_ARCH}'], make_host_mesh(devices="
                  f"{[str(d) for d in devices]}))",
          "shards": _shards_on(devices),
          "label": (f"{D} shards of one card: shards run in turn, no copies "
                    "between cards" if len(set(map(str, devices))) == 1
                    else "one shard a card"),
          "B": LM_BATCH, "S": LM_PROMPT, "ctx": LM_CTX,
          "decode_steps": LM_DECODE,
          "flash_attention_sm90_launches_per_prefill": launches,
          "first_run_s": first_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
          "decode_s": decode_s,
          "decode_tokens_per_s": LM_BATCH * LM_DECODE / decode_s,
          "peak_memory_bytes": peak,
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "shards": _shards_on(dev32),
                         "flash_attention_simt_launches": launches32,
                         "logits_max_abs_err": err,
                         "greedy_tokens_equal": LM_GREEDY_CHECK}})
    return launches, launches32


TP_SHARDS = 4              # lm_train_tp's and lm_serve_tp's model shards
TP_TIMED = 2               # lm_train_tp's timed steps, after a warm-up
TP_DECODE = 8              # lm_serve_tp's greedy steps


def _blocks_differ(torch, SH, tree) -> int:
    """Blocks of a tree of ``ShardedTensor`` that are not bit-equal to
    the first block of the same slice of their leaf: the model replicas
    of a leaf whole on the model axis, and the data replicas of each."""
    n = 0
    for t in SH.tree_leaves(tree):
        first = {}
        for pos in np.ndindex(t.blocks.shape):
            key = tuple((s.start, s.stop)
                        for s in t.sharding.block(t.shape, pos))
            b = t.blocks[pos]
            if key in first:
                n += not torch.equal(first[key], b.to(first[key].device))
            else:
                first[key] = b
    return n


def _whole_extra(p_specs, p_shapes, M) -> tuple:
    """(elements, bytes) that the leaves the guard keeps whole on the
    model axis add over M shards: M - 1 more copies of each."""
    n = b = 0
    for spec, t in zip(_leaves(p_specs), _leaves(p_shapes)):
        if "model" not in tuple(spec):
            n += (M - 1) * t.numel()
            b += (M - 1) * t.numel() * t.element_size()
    return n, b


def phase_lm_train_tp(torch, fa, kv, steps, ARCHS, adamw, TokenPipeline,
                      PipelineConfig, SH, TP, make_host_mesh,
                      place=one_card):
    """qwen3-0.6b at full width and depth trained tensor-parallel over
    TP_SHARDS model shards (``place``: of card 0, or one a card), mesh
    (1, TP_SHARDS), through ``make_train_step(cfg, mesh)``: ``lm_train``'s
    params (seed 0, drawn into their blocks by ``SH.init_sharded``, the
    moments by ``SH.zeros_tree``) and batches, placed by ``train_specs``,
    a warm-up and TP_TIMED timed steps. Each shard runs its 4 query and 2
    KV heads, so a step must launch TP_SHARDS x 56
    ``flash_attention_sm90`` and TP_SHARDS x 28
    ``flash_attention_bwd_sm90`` and nothing else; the
    model replicas of every leaf the guard keeps whole (the norms) stay
    bit-equal; the model-axis sums and gathers are timed by CUDA events
    (``tensor_parallel.timed_collectives``). Then in float32 at
    CHECK_LAYERS layers on mesh (2, 2): the step against the one-device
    step on the same params and CHECK_B x CHECK_S batch, the loss within
    1e-5 of its size, every gradient leaf (joined from the blocks AdamW
    was handed) within 1e-5 of its max, the params after AdamW within
    1e-6, the data and model replicas bit-equal. Returns the bf16 run's
    launches of each kernel and the float32 step's."""
    from unittest import mock
    cfg = ARCHS[LM_ARCH]
    M = TP_SHARDS
    devices = place(M)
    mesh = make_host_mesh(M, devices)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, TRAIN_S, TRAIN_B))
    model, step, p_shapes, o_shapes = steps.make_train_step(cfg, mesh)
    p_specs, o_specs = steps.train_specs(cfg, mesh, p_shapes)
    _reset_peak(torch, devices)
    base = {str(d): torch.cuda.memory_allocated(d) for d in set(devices)}
    pr = SH.init_sharded(model, torch.Generator(
        device=devices[0]).manual_seed(0), SH.to_named(mesh, p_specs))
    orr = SH.zeros_tree(o_shapes, SH.to_named(mesh, o_specs))
    place_peak = _peak(torch, devices)
    _reset_peak(torch, devices)
    want = {"flash_attention_sm90": 2 * cfg.n_layers * M,
            "flash_attention_simt": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_sm90": cfg.n_layers * M}
    losses, gnorms, step_s, differ, colls = [], [], [], [], []
    for i in range(1 + TP_TIMED):
        batch = _batch(torch, pipe, i)
        _sync_all(torch)
        t0 = time.perf_counter()
        with TP.timed_collectives() as coll:
            pr, orr, metrics = _counted(
                fa, kv, lambda: step(pr, orr, batch), want,
                f"tp train step {i + 1}")
        _sync_all(torch)
        step_s.append(time.perf_counter() - t0)
        colls.append(coll)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
        differ.append(_blocks_differ(torch, SH, pr)
                      + _blocks_differ(torch, SH, orr))
    peak = _peak(torch, devices)
    if any(differ):
        raise AssertionError(f"tp train: replicas differ ({differ} blocks "
                             "a step)")
    if not all(np.isfinite(losses + gnorms)) or min(gnorms) <= 0:
        raise AssertionError(f"tp train: loss {losses}, gnorm {gnorms}")
    launches = {k: v * (1 + TP_TIMED) for k, v in want.items()}
    del pr, orr, metrics, batch
    torch.cuda.empty_cache()

    # float32, CHECK_LAYERS layers, mesh (2, 2) vs one device
    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    dev32 = place(4)
    mesh32 = make_host_mesh(2, dev32)
    m32, one32, _, _ = steps.make_train_step(cfg32, dev32[0])
    _, tp32, s32, _ = steps.make_train_step(cfg32, mesh32)
    ps32, os32 = steps.train_specs(cfg32, mesh32, s32)
    p0 = m32.init(torch.Generator(device=dev32[0]).manual_seed(1))
    o0 = adamw.init(p0)
    b0 = _batch(torch, TokenPipeline(PipelineConfig(
        cfg.vocab, CHECK_S, CHECK_B)), 0)
    (p1, _, m1), g1 = _spied_step(torch, steps, adamw, one32, p0, o0, b0)
    P32 = SH.shard_tree(p0, SH.to_named(mesh32, ps32))
    O32 = SH.shard_tree(o0, SH.to_named(mesh32, os32))
    seen, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        seen.append(g)
        return apply(p, g, o, **kw)

    n_pos = mesh32.size
    want32 = {"flash_attention_sm90": 0,
              "flash_attention_simt": 2 * CHECK_LAYERS * n_pos,
              "flash_attention_bwd": CHECK_LAYERS * n_pos,
              "flash_attention_bwd_sm90": 0}
    with mock.patch.object(adamw, "apply", spy):
        pd, od, md = _counted(fa, kv, lambda: tp32(P32, O32, b0), want32,
                              "float32 tp step")
    flat = [p for row in TP.grid(mesh32) for p in row]
    gd = SH.gather_tree(TP.assemble(P32, dict(zip(flat, seen))))
    grad_err = max(float((a.to(b.device) - b).abs().max())
                   / float(b.abs().max())
                   for a, b in zip(adamw.leaves(gd), adamw.leaves(g1)))
    param_err = max(float((a.to(b.device) - b).abs().max())
                    for a, b in zip(adamw.leaves(SH.gather_tree(pd)),
                                    adamw.leaves(p1)))
    loss_err32 = abs(float(md["loss"]) - float(m1["loss"]))
    differ32 = _blocks_differ(torch, SH, pd) + _blocks_differ(torch, SH, od)
    if (not grad_err <= 1e-5 or not param_err <= 1e-6
            or not loss_err32 <= 1e-5 * abs(float(m1["loss"])) or differ32):
        raise AssertionError(
            f"float32 tp step != one-device step: gradients {grad_err} of "
            f"a leaf's max, params {param_err}, loss {loss_err32}, "
            f"{differ32} replica blocks differ")
    del p0, o0, p1, g1, P32, O32, pd, od, gd, seen
    torch.cuda.empty_cache()
    ntok = TRAIN_B * TRAIN_S
    n_params = sum(t.numel() for t in adamw.leaves(p_shapes))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in adamw.leaves(p_shapes))
    extra_n, extra_b = _whole_extra(p_specs, p_shapes, M)
    # what the step holds at once, from the shapes (the leaves kept whole
    # once a shard), at the larger of its two high points: the backward,
    # beside the params and moments, holds the fp32 logits (a vocab block
    # a shard), their exponentials saved for it and their gradient, and
    # the gradients it fills; AdamW holds the gradients beside the
    # caller's params and moments and the new ones it makes
    held = {"params": param_bytes + extra_b,
            "adam_m_and_v": 8 * (n_params + extra_n),
            "grads": param_bytes + extra_b}
    logits = 4 * ntok * cfg.vocab
    backward = {**held, "fp32_logits": logits, "fp32_exp_logits": logits,
                "fp32_logits_grad": logits}
    optimizer = {**held, "new_params_and_moments": held["params"]
                 + held["adam_m_and_v"]}
    reckoning = {"backward": {**backward, "total": sum(backward.values())},
                 "adamw": {**optimizer, "total": sum(optimizer.values())}}
    reckoning["total"] = max(reckoning["backward"]["total"],
                             reckoning["adamw"]["total"])
    sums = [c.get("sum", {"calls": 0, "ms": 0.0}) for c in colls]
    gathers = [c.get("gather", {"calls": 0, "ms": 0.0}) for c in colls]
    emit({"phase": "lm_train_tp", "arch": LM_ARCH,
          "call": f"repro_torch.launch.steps.make_train_step(ARCHS"
                  f"['{LM_ARCH}'], make_host_mesh({M}, "
                  f"{[str(d) for d in devices]}))",
          "mesh": dict(mesh.shape), "shards": _shards_on(devices),
          "label": (f"{M} model shards of one card: shards run in turn, no "
                    "copies between cards" if len(set(map(str, devices)))
                    == 1 else "one model shard a card"),
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "params": n_params, "dtype": cfg.dtype,
          "heads_a_shard": [cfg.n_heads // M, cfg.n_kv_heads // M],
          "B": TRAIN_B, "S": TRAIN_S, "tokens_per_step": ntok,
          "launches_per_step": want, "step_s": step_s,
          "tokens_per_s": [ntok / t for t in step_s],
          "loss": losses, "gnorm": gnorms,
          "model_axis_sums_per_step": sums,
          "model_axis_gathers_per_step": gathers,
          "replica_blocks_differing_per_step": differ,
          "peak_memory_bytes": peak, "placement_peak_bytes": place_peak,
          "base_bytes": base,
          "memory_reckoning_bytes": reckoning,
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "mesh": dict(mesh32.shape),
                         "shards": _shards_on(dev32), "launches": want32,
                         "grad_err_over_leaf_max": grad_err,
                         "param_max_abs_err": param_err,
                         "loss_abs_err": loss_err32}})
    return launches, want32


def _route_flips(torch, MOE, prefill, pr, tokens, cache, one_routes,
                 moe_logits) -> dict:
    """The routes a tensor-parallel prefill picks against the one-device
    prefill's (``one_routes``, on the same prompts and params): each
    layer's share of (token, k) routes that differ (``MOE.route_flips``);
    then the prefill again with every layer's route forced to the
    one-device one, and its logits' max difference from the one-device
    logits ``moe_logits``."""
    from unittest import mock
    tp_routes = []
    with _spy_routes(MOE, tp_routes):
        prefill(pr, {"tokens": tokens}, cache)
    if len(tp_routes) != len(one_routes):
        raise AssertionError(f"route flips: {len(tp_routes)} routes vs "
                             f"{len(one_routes)}")
    pairs = one_routes[0].gate_idx.numel()
    share = [MOE.route_flips(a, b) / pairs
             for a, b in zip(tp_routes, one_routes)]
    forced = iter(one_routes)
    with mock.patch.object(MOE, "route", lambda *a, **kw: next(forced)):
        lf, _ = prefill(pr, {"tokens": tokens}, cache)
    torch.cuda.synchronize()
    return {"pairs_a_layer": pairs, "flipped_share_by_layer": share,
            "flipped_share": sum(share) / len(share),
            "first_layer_with_a_flip": next(
                (i for i, x in enumerate(share) if x > 0), None),
            "forced_routes_logits_max_abs_diff": float(
                (lf.float().cpu() - moe_logits).abs().max())}


def phase_lm_serve_tp(torch, fa, kv, steps, ARCHS, SH, make_host_mesh,
                      moe_logits, MOE=None, moe_routes=None,
                      place=one_card):
    """deepseek-moe-16b at full width and depth served expert-parallel
    over TP_SHARDS model shards (mesh (1, TP_SHARDS); 16 experts, 4 query
    and 4 KV heads, a quarter of the vocab, the shared experts' hidden and
    the cache's KV heads a shard) through ``make_serve_steps(cfg, mesh)``:
    ``lm_serve_moe``'s params (seed MOE_SEED, drawn into the blocks
    ``param_specs`` places by ``SH.init_sharded``) and LM_BATCH prompts of
    LM_PROMPT tokens, a counted prefill (a ``flash_attention_sm90`` launch
    a layer a shard) and TP_DECODE greedy steps, then a timed prefill and
    the decode loop again. The prefill's bf16 last-position logits beside
    ``lm_serve_moe``'s (``moe_logits``). In float32 at CHECK_LAYERS layers
    on the same mesh, CHECK_B x CHECK_S tokens: the prefill's logits
    within 1e-4 of the one-device serve's and LM_GREEDY_CHECK greedy
    tokens equal. Given ``lm_serve_moe``'s routes (``moe_routes``), the
    share of routes the tensor-parallel prefill picks otherwise, and its
    logits with the one-device routes forced (``_route_flips``). Returns
    the bf16 run's ``flash_attention_sm90`` launches and the float32
    prefill's ``flash_attention_simt`` launches."""
    cfg = ARCHS[MOE_ARCH]
    M = TP_SHARDS
    devices = place(M)
    mesh = make_host_mesh(M, devices)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    tokens = torch.from_numpy(np.random.default_rng(MOE_SEED + 13).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(devices[0])
    _reset_peak(torch, devices)
    base = {str(d): torch.cuda.memory_allocated(d) for d in set(devices)}
    t0 = time.perf_counter()
    shapes = model.abstract_params()
    n_params = sum(t.numel() for t in _leaves(shapes))
    pr = SH.init_sharded(model, torch.Generator(device=devices[0]).manual_seed(
        MOE_SEED), SH.to_named(mesh, SH.param_specs(cfg, mesh, shapes)))
    ctx = LM_PROMPT + TP_DECODE
    cache = steps.shard_cache(cfg, mesh, model.make_cache(LM_BATCH, ctx))
    _sync_all(torch)
    init_s = time.perf_counter() - t0
    init_peak = _peak(torch, devices)
    _reset_peak(torch, devices)
    want = {"flash_attention_sm90": cfg.n_layers * M,
            "flash_attention_simt": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_sm90": 0}

    def run():
        logits, c = prefill(pr, {"tokens": tokens}, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out = [tok]
        for i in range(TP_DECODE):
            tok, c = decode(pr, tok, c, LM_PROMPT + i)
            out.append(tok)
        return logits, torch.cat(out, 1)

    _sync_all(torch)
    t0 = time.perf_counter()
    logits, gen = _counted(fa, kv, run, want, "tp serve")
    _sync_all(torch)
    first_s = time.perf_counter() - t0
    if (not bool(torch.isfinite(logits).all())
            or logits.shape != (LM_BATCH, 1, cfg.vocab)
            or gen.shape != (LM_BATCH, TP_DECODE + 1)
            or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab):
        raise AssertionError("tp serving gave non-finite logits or bad "
                             "tokens")
    vs_one = float((logits.float().cpu() - moe_logits).abs().max())
    vs_one_scale = float(moe_logits.abs().max())
    argmax_equal = int((torch.argmax(logits.float().cpu()[:, -1], -1)
                        == torch.argmax(moe_logits[:, -1], -1)).sum())
    _, prefill_s = _synced(torch, lambda: prefill(pr, {"tokens": tokens},
                                                  cache))
    tok = gen[:, :1]

    def loop():
        t = tok
        for i in range(TP_DECODE):
            t, _ = decode(pr, t, cache, LM_PROMPT + i)

    _, decode_s = _synced(torch, loop)
    peak = _peak(torch, devices)
    flips = None if moe_routes is None else _route_flips(
        torch, MOE, prefill, pr, tokens, cache, moe_routes, moe_logits)
    del pr, cache, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    m1, pre1, dec1 = steps.make_serve_steps(cfg32, devices[0])
    _, pre_tp, dec_tp = steps.make_serve_steps(cfg32, mesh)
    p32 = m1.init(torch.Generator(device=devices[0]).manual_seed(1))
    toks32 = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (CHECK_B, CHECK_S))).to(devices[0])
    ctx32 = CHECK_S + LM_GREEDY_CHECK

    def greedy(pre, dec, params, cache):
        logits, cache = pre(params, {"tokens": toks32}, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out = [tok]
        for i in range(LM_GREEDY_CHECK - 1):
            tok, cache = dec(params, tok, cache, CHECK_S + i)
            out.append(tok)
        return logits, torch.cat(out, 1)

    l1, t1 = greedy(pre1, dec1, p32, m1.make_cache(CHECK_B, ctx32))
    p32_tp = SH.shard_tree(p32, SH.to_named(
        mesh, SH.param_specs(cfg32, mesh, p32)))
    fa.reset_counts()
    lt, tt = greedy(pre_tp, dec_tp, p32_tp, steps.shard_cache(
        cfg32, mesh, m1.make_cache(CHECK_B, ctx32)))
    launches32 = fa.COUNTS["flash_attention_simt"]
    err = float((lt - l1).abs().max())
    if (err > 1e-4 or not torch.equal(tt, t1)
            or launches32 != CHECK_LAYERS * M):
        raise AssertionError(f"float32 tp serve != one-device serve: logits "
                             f"{err}, tokens {tt.tolist()} vs {t1.tolist()}, "
                             f"{launches32} flash_attention_simt launches")
    del p32, p32_tp
    torch.cuda.empty_cache()
    launches = want["flash_attention_sm90"]
    emit({"phase": "lm_serve_tp", "arch": MOE_ARCH,
          "call": f"repro_torch.launch.steps.make_serve_steps(ARCHS"
                  f"['{MOE_ARCH}'], make_host_mesh({M}, "
                  f"{[str(d) for d in devices]}))",
          "mesh": dict(mesh.shape), "shards": _shards_on(devices),
          "experts_a_shard": cfg.n_experts // M,
          "heads_a_shard": [cfg.n_heads // M, cfg.n_kv_heads // M],
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "params": n_params, "dtype": cfg.dtype,
          "B": LM_BATCH, "S": LM_PROMPT, "ctx": ctx,
          "decode_steps": TP_DECODE,
          "flash_attention_sm90_launches_per_prefill": launches,
          "init_and_place_s": init_s, "init_peak_bytes": init_peak,
          "first_run_s": first_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
          "decode_s": decode_s,
          "decode_tokens_per_s": LM_BATCH * TP_DECODE / decode_s,
          "peak_memory_bytes": peak, "base_bytes": base,
          "bf16_logits_vs_lm_serve_moe": {
              "max_abs_diff": vs_one, "max_abs_one_device": vs_one_scale,
              "rows_with_the_same_argmax": argmax_equal},
          "route_flips_vs_lm_serve_moe": flips,
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "mesh": dict(mesh.shape),
                         "flash_attention_simt_launches": launches32,
                         "logits_max_abs_err": err,
                         "greedy_tokens_equal": LM_GREEDY_CHECK}})
    return launches, launches32


STACKS_S = 512             # lm_tp_stacks' zamba2 and xLSTM tokens a row
STACKS_DECODE = 8          # its greedy steps a model
SEQ_DECODE = 8             # lm_serve_seq's greedy steps


def _kernels(**launches) -> dict:
    """Each flash kernel's launches: those named, 0 for the rest."""
    return {"flash_attention_sm90": 0, "flash_attention_simt": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0,
            **launches}


def _tp_greedy(torch, prefill, decode, params, batch, cache, n, start):
    """The prefill's logits and ``n`` greedy tokens after them."""
    logits, cache = prefill(params, batch, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(n - 1):
        tok, cache = decode(params, tok, cache, start + i)
        out.append(tok)
    return logits, torch.cat(out, 1)


def _tp_train_reckoning(adamw, p_specs, p_shapes, M) -> dict:
    """``_train_reckoning`` over M model shards: the leaves the guard
    keeps whole once a shard more (``_whole_extra``)."""
    n = sum(t.numel() for t in adamw.leaves(p_shapes))
    p = sum(t.numel() * t.element_size() for t in adamw.leaves(p_shapes))
    extra_n, extra_b = _whole_extra(p_specs, p_shapes, M)
    out = {"params": p + extra_b, "grads": p + extra_b,
           "adam_m_and_v": 8 * (n + extra_n),
           "new_params_and_moments": p + extra_b + 8 * (n + extra_n)}
    out["total"] = sum(out.values())
    return out


FP32_GRAD_VS_F64 = 1e-2    # a float32 gradient leaf from float64's, of its max
FP32_LOGITS_VS_F64 = 1e-3  # float32 logits from float64's, of their max


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    b = b.to(a.device)
    return float((a - b).abs().max()) / float(b.abs().max())


def _f64_tree(torch, tree):
    """``tree`` (params or a batch) with every float leaf in float64."""
    if isinstance(tree, dict):
        return {k: _f64_tree(torch, v) for k, v in tree.items()}
    return tree.double() if tree.is_floating_point() else tree


def _tp_fp32_train(torch, fa, kv, steps, adamw, SH, TP, cfg32, mesh, batch,
                   want_one, want_tp, tag) -> dict:
    """``cfg32`` (float32) trained one step over ``mesh`` against one
    device on the same params (seed 1) and ``batch``, with the float64
    evaluation of the same function as the yardstick
    (``models/float64.in_float64``: every float32 of the model code in
    float64, attention on its plain version, no kernel launched):

    * float64: the tensor-parallel loss and gradients (``TP.shard_grads``)
      against one device's, at the CPU tests' tolerances: the loss within
      rtol 1e-5, gnorm 1e-4, every gradient leaf within 1e-4 of its max.
      This holds the sharded math at full width.
    * float32, counted (``want_one``, ``want_tp`` flash launches): the
      one-device gradients and the tensor-parallel step's (joined from the
      blocks AdamW was handed) each within FP32_GRAD_VS_F64 of a leaf's
      max of the float64 gradients, gnorm likewise; the loss within rtol
      1e-5 of one device's, the params after the step within 1e-6 of
      ``adamw.apply`` of its gradients, the replicas bit-equal. (At full
      width the recurrent stacks amplify float32's rounding to 1e-3 of a
      leaf's max, so two float32 runs cannot meet 1e-4 of each other;
      each is held to float64 instead.)

    The tensor-parallel step's params are drawn into their blocks
    (``SH.init_sharded``, the one-device params' bits) once the float64
    runs are done. The gradients wait on the host, and each tree is freed
    as soon as it is used, so that zamba2's 9 layers fit."""
    from unittest import mock
    from repro_torch.models.float64 import in_float64
    from repro_torch.models.model import build
    dev = mesh.devices.flat[0]
    m32 = steps.make_train_step(cfg32, dev)[0]
    _, tp32, s32, o32 = steps.make_train_step(cfg32, mesh)
    ps32, os32 = steps.train_specs(cfg32, mesh, s32)
    p0 = m32.init(torch.Generator(device=dev).manual_seed(1))
    loss1, g1 = _counted(fa, kv, lambda: _loss_grads(
        torch, adamw, m32, p0, batch), want_one, f"{tag} one device")

    def norm(leaves):
        return math.sqrt(sum(float(x.double().square().sum())
                             for x in leaves))

    gn1 = norm(adamw.leaves(g1))
    g1 = adamw.tree_map(lambda g: g.cpu(), g1)

    cfg64 = cfg32.scaled(dtype="float64")
    m64, b64 = build(cfg64, dev), _f64_tree(torch, batch)
    with in_float64():
        p64 = _f64_tree(torch, p0)
        loss64, g64 = _counted(fa, kv, lambda: _loss_grads(
            torch, adamw, m64, p64, b64), _kernels(), f"{tag} float64")
        gn64 = norm(adamw.leaves(g64))
        g64 = adamw.tree_map(lambda g: g.cpu(), g64)
        P64 = SH.shard_tree(p64, SH.to_named(mesh, SH.param_specs(
            cfg64, mesh, m64.abstract_params())))
        del p64
        # the metrics, like the losses, hold the graph and so its leaves
        # (P64's blocks) and their grads until they are dropped
        _, losses, metrics, gr = _counted(fa, kv, lambda: TP.shard_grads(
            m64.loss_tp, mesh, P64, b64), _kernels(), f"{tag} float64 tp")
        row = TP.grid(mesh)[0]
        gt64 = TP.assemble(P64, dict(zip(row, gr[0])))
        del P64, gr, metrics
        loss_err64 = abs(float(losses[0].detach()) - loss64) / abs(loss64)
        gnorm_err64 = abs(norm(t.gather() for t in SH.tree_leaves(gt64))
                          - gn64) / gn64
        grad_err64 = max(_rel(t.gather(), w) for t, w in zip(
            SH.tree_leaves(gt64), adamw.leaves(g64)))
        del gt64, losses
    torch.cuda.empty_cache()
    one_err = max(_rel(g.to(dev), w) for g, w in zip(adamw.leaves(g1),
                                                     adamw.leaves(g64)))
    del p0
    torch.cuda.empty_cache()
    P32 = SH.init_sharded(m32, torch.Generator(device=dev).manual_seed(1),
                          SH.to_named(mesh, ps32))
    O32 = SH.zeros_tree(o32, SH.to_named(mesh, os32))
    seen, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        seen.append(g)
        return apply(p, g, o, **kw)

    with mock.patch.object(adamw, "apply", spy):
        pd, od, md = _counted(fa, kv, lambda: tp32(P32, O32, batch),
                              want_tp, f"{tag} tensor-parallel")
    differ = _blocks_differ(torch, SH, pd) + _blocks_differ(torch, SH, od)
    del O32, od
    flat = [p for row in TP.grid(mesh) for p in row]
    gd = TP.assemble(P32, dict(zip(flat, seen)))
    del seen
    tp_err = vs_one = param_err = 0.0
    gnorm = md["gnorm"]
    for g_t, g_one, g_64, p_old, p_new in zip(
            SH.tree_leaves(gd), adamw.leaves(g1), adamw.leaves(g64),
            SH.tree_leaves(P32), SH.tree_leaves(pd)):
        g = g_t.gather()
        tp_err = max(tp_err, _rel(g.double(), g_64))
        vs_one = max(vs_one, _rel(g, g_one))
        old = p_old.gather()
        want, _, _ = apply({"x": old}, {"x": g}, adamw.init({"x": old}),
                           gnorm=gnorm.to(old.device))
        param_err = max(param_err, float(
            (p_new.gather() - want["x"]).abs().max()))
        del g, old, want
    loss_err = abs(float(md["loss"]) - loss1) / abs(loss1)
    gnorm_one = abs(gn1 - gn64) / gn64
    gnorm_tp = abs(float(gnorm) - gn64) / gn64
    del P32, pd, gd, g1, g64
    torch.cuda.empty_cache()
    if (not loss_err64 <= 1e-5 or not gnorm_err64 <= 1e-4
            or not grad_err64 <= 1e-4):
        raise AssertionError(
            f"{tag} float64 tensor-parallel gradients != one device's: "
            f"loss {loss_err64}, gnorm {gnorm_err64}, gradients "
            f"{grad_err64} of a leaf's max")
    if (not loss_err <= 1e-5 or not max(one_err, tp_err) <= FP32_GRAD_VS_F64
            or not max(gnorm_one, gnorm_tp) <= FP32_GRAD_VS_F64
            or not param_err <= 1e-6 or differ):
        raise AssertionError(
            f"{tag} float32 step off: loss {loss_err} from one device's; "
            f"gradients {one_err} (one device) and {tp_err} "
            f"(tensor-parallel) of a leaf's max from float64's, gnorm "
            f"{gnorm_one} and {gnorm_tp} (bound {FP32_GRAD_VS_F64}); params "
            f"{param_err}; {differ} replica blocks differ")
    return {"n_layers": cfg32.n_layers,
            "float64_tp_vs_one_device": {
                "loss_rel_err": loss_err64, "gnorm_rel_err": gnorm_err64,
                "grad_err_over_leaf_max": grad_err64},
            "float32_vs_float64": {
                "one_device_grad_err_over_leaf_max": one_err,
                "tp_grad_err_over_leaf_max": tp_err,
                "one_device_gnorm_rel_err": gnorm_one,
                "tp_gnorm_rel_err": gnorm_tp, "bound": FP32_GRAD_VS_F64},
            "float32_tp_vs_one_device": {
                "loss_rel_err": loss_err, "grad_err_over_leaf_max": vs_one},
            "param_max_abs_err_vs_adamw_of_its_grads": param_err,
            "launches": {"one_device": want_one, "tensor_parallel": want_tp}}


def _tp_fp32_serve(torch, fa, kv, steps, adamw, SH, cfg32, mesh, batch,
                   n_attn, tag) -> dict:
    """``cfg32`` (float32) served over ``mesh`` against one device on the
    same params (seed 1) and ``batch``, with the float64 evaluation as
    the yardstick (``_tp_fp32_train``): in float64 the tensor-parallel
    prefill's logits within 1e-5 of one device's max and LM_GREEDY_CHECK
    greedy tokens equal (the CPU tests' tolerance); in float32 the
    one-device and the tensor-parallel logits each within
    FP32_LOGITS_VS_F64 of float64's max, and their greedy tokens equal.
    The float32 tensor-parallel prefill launches ``flash_attention_simt``
    ``n_attn`` times a model shard; the float64 runs launch nothing. The
    tensor-parallel serve's params are drawn into their blocks
    (``SH.init_sharded``), as in ``_tp_fp32_train``."""
    from repro_torch.models.float64 import in_float64
    dev = mesh.devices.flat[0]
    M = mesh.shape["model"]
    S = batch["tokens"].shape[1]
    ctx = S + LM_GREEDY_CHECK
    B = batch["tokens"].shape[0]
    m1, pre1, dec1 = steps.make_serve_steps(cfg32, dev)
    p32 = m1.init(torch.Generator(device=dev).manual_seed(1))
    l1, t1 = _tp_greedy(torch, pre1, dec1, p32, batch, m1.make_cache(B, ctx),
                        LM_GREEDY_CHECK, S)
    cfg64 = cfg32.scaled(dtype="float64")
    b64 = _f64_tree(torch, batch)
    with in_float64():
        m64, pre64, dec64 = steps.make_serve_steps(cfg64, dev)
        p64 = _f64_tree(torch, p32)
        del p32
        l64, t64 = _counted(fa, kv, lambda: _tp_greedy(
            torch, pre64, dec64, p64, b64, m64.make_cache(B, ctx),
            LM_GREEDY_CHECK, S), _kernels(), f"{tag} float64")
        _, pre, dec = steps.make_serve_steps(cfg64, mesh)
        P64 = SH.shard_tree(p64, SH.to_named(
            mesh, SH.param_specs(cfg64, mesh, m64.abstract_params())))
        del p64
        lt64, tt64 = _counted(fa, kv, lambda: _tp_greedy(
            torch, pre, dec, P64, b64, steps.shard_cache(
                cfg64, mesh, m64.make_cache(B, ctx)), LM_GREEDY_CHECK, S),
            _kernels(), f"{tag} float64 tp")
        del P64
    err64 = _rel(lt64, l64)
    _, pre, dec = steps.make_serve_steps(cfg32, mesh)
    P = SH.init_sharded(m1, torch.Generator(device=dev).manual_seed(1),
                        SH.to_named(mesh, SH.param_specs(
                            cfg32, mesh, m1.abstract_params())))
    fa.reset_counts()
    lt, tt = _tp_greedy(torch, pre, dec, P, batch, steps.shard_cache(
        cfg32, mesh, m1.make_cache(B, ctx)), LM_GREEDY_CHECK, S)
    launches = dict(fa.COUNTS)
    one_err, tp_err = _rel(l1.double(), l64), _rel(lt.double(), l64)
    del P
    torch.cuda.empty_cache()
    if (err64 > 1e-5 or not torch.equal(tt64, t64)
            or max(one_err, tp_err) > FP32_LOGITS_VS_F64
            or not torch.equal(tt, t1)
            or launches != _kernels(flash_attention_simt=n_attn * M)):
        raise AssertionError(
            f"{tag} tensor-parallel serve off: float64 logits {err64} of "
            f"one device's max, tokens {tt64.tolist()} vs {t64.tolist()}; "
            f"float32 logits {one_err} (one device) and {tp_err} "
            f"(tensor-parallel) of float64's max (bound "
            f"{FP32_LOGITS_VS_F64}), tokens {tt.tolist()} vs "
            f"{t1.tolist()}; launches {launches}")
    return {"n_layers": cfg32.n_layers, "B": B, "S": S,
            "float64_tp_logits_err_over_max": err64,
            "float32_one_device_logits_err_over_f64_max": one_err,
            "float32_tp_logits_err_over_f64_max": tp_err,
            "greedy_tokens_equal": LM_GREEDY_CHECK, "launches": launches}


def _tp_stack(torch, fa, kv, steps, adamw, SH, TP, mesh, devices, cfg, S,
              batch_at, extra, n_attn, fwd, bwd, tag) -> dict:
    """``cfg`` (bf16, weights from seed 0 drawn into their blocks by
    ``SH.init_sharded``) on ``mesh``: the one-device loss of batch 0 (on
    the blocks gathered), then through ``make_train_step(cfg, mesh)`` a
    warm-up and a timed step (each must launch ``fwd`` 2 x ``n_attn`` and
    ``bwd`` ``n_attn`` times a model shard: each attention's forward and
    its recompute under the layer's checkpoint, and its backward), the
    model and data replicas bit-equal after each; then the trained params
    served
    through ``make_serve_steps(cfg, mesh)``: a prefill of batch 0's
    prompts (``n_attn`` ``fwd`` launches a shard) and STACKS_DECODE greedy
    steps, timed. Returns the numbers."""
    M = mesh.shape["model"]
    model, step, p_shapes, o_shapes = steps.make_train_step(cfg, mesh)
    p_specs, o_specs = steps.train_specs(cfg, mesh, p_shapes)
    _reset_peak(torch, devices)
    pr = SH.init_sharded(model, torch.Generator(
        device=devices[0]).manual_seed(0), SH.to_named(mesh, p_specs))
    orr = SH.zeros_tree(o_shapes, SH.to_named(mesh, o_specs))
    batches = [{**batch_at(i), **extra} for i in range(2)]
    with torch.no_grad():
        one_loss = float(model.loss(SH.gather_tree(pr), batches[0])[0])
    torch.cuda.empty_cache()
    place_peak = _peak(torch, devices)
    _reset_peak(torch, devices)
    want = _kernels(**({fwd: 2 * n_attn * M, bwd: n_attn * M}
                       if n_attn else {}))
    losses, gnorms, step_s, differ, colls = [], [], [], [], []
    for i, batch in enumerate(batches):
        _sync_all(torch)
        t0 = time.perf_counter()
        with TP.timed_collectives() as coll:
            pr, orr, metrics = _counted(fa, kv, lambda: step(pr, orr, batch),
                                        want, f"{tag} train step {i + 1}")
        _sync_all(torch)
        step_s.append(time.perf_counter() - t0)
        colls.append(coll)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
        differ.append(_blocks_differ(torch, SH, pr)
                      + _blocks_differ(torch, SH, orr))
    train_peak = _peak(torch, devices)
    if any(differ):
        raise AssertionError(f"{tag}: replicas differ ({differ} blocks)")
    if not all(np.isfinite(losses + gnorms)) or min(gnorms) <= 0:
        raise AssertionError(f"{tag}: loss {losses}, gnorm {gnorms}")
    del orr, metrics
    torch.cuda.empty_cache()
    _reset_peak(torch, devices)
    _, prefill, decode = steps.make_serve_steps(cfg, mesh)
    B = batches[0]["tokens"].shape[0]
    cache = steps.shard_cache(cfg, mesh, model.make_cache(
        B, S + STACKS_DECODE))
    prompt = {k: v for k, v in batches[0].items() if k != "labels"}
    want_serve = _kernels(**({fwd: n_attn * M} if n_attn else {}))

    def serve():
        (logits, c), pre_s = _synced(torch, lambda: prefill(pr, prompt,
                                                            cache))
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

        def loop():
            t = tok
            for i in range(STACKS_DECODE):
                t, _ = decode(pr, t, c, S + i)
            return t
        last, dec_s = _synced(torch, loop)
        return logits, last, pre_s, dec_s

    logits, last, prefill_s, decode_s = _counted(fa, kv, serve, want_serve,
                                                 f"{tag} serve")
    serve_peak = _peak(torch, devices)
    if (not bool(torch.isfinite(logits).all())
            or int(last.min()) < 0 or int(last.max()) >= cfg.vocab):
        raise AssertionError(f"{tag}: serving gave non-finite logits or "
                             "bad tokens")
    del pr, cache, logits
    torch.cuda.empty_cache()
    ntok = B * S
    zero = {"calls": 0, "ms": 0.0}
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype,
            "params": sum(t.numel() for t in adamw.leaves(p_shapes)),
            "B": B, "S": S, "tokens_per_step": ntok,
            "launches_per_step": want,
            "launches_from_code": {
                "attention_calls_a_forward_a_shard": n_attn,
                "train_step": f"{fwd}: 2 x {n_attn} x {M}, "
                              f"{bwd}: {n_attn} x {M}" if n_attn else "none",
                "prefill": f"{fwd}: {n_attn} x {M}" if n_attn else "none"},
            "step_s": step_s, "tokens_per_s": [ntok / t for t in step_s],
            "loss": losses, "gnorm": gnorms,
            "one_device_loss_step_1": one_loss,
            "model_axis_sums_per_step": [c.get("sum", zero) for c in colls],
            "model_axis_gathers_per_step": [c.get("gather", zero)
                                            for c in colls],
            "replica_blocks_differing_per_step": differ,
            "placement_peak_bytes": place_peak,
            "train_peak_bytes": train_peak,
            "memory_reckoning_bytes": _tp_train_reckoning(
                adamw, p_specs, p_shapes, M),
            "prefill_launches": want_serve, "prefill_s": prefill_s,
            "prefill_tokens_per_s": ntok / prefill_s,
            "decode_steps": STACKS_DECODE, "decode_s": decode_s,
            "decode_tokens_per_s": B * STACKS_DECODE / decode_s,
            "serve_peak_bytes": serve_peak}


def phase_lm_tp_stacks(torch, fa, kv, steps, ARCHS, adamw, TokenPipeline,
                       PipelineConfig, SH, TP, make_host_mesh, smi,
                       profile_serve, place=one_card):
    """zamba2, xLSTM and whisper tensor-parallel over TP_SHARDS model
    shards (mesh (1, TP_SHARDS); ``place``: of card 0, or one a card),
    train and serve, at full width (``_tp_stack``): zamba2-7b at
    SSM_CHECK_LAYERS of its 81 layers (a group of six with its shared
    attention, on ``flash_attention_sm90`` at dh 112 over 8 of its 32
    heads a shard, and a tail of three) and xlstm-125m whole (one of its
    4 heads a shard, no kernel), each on TRAIN_B x STACKS_S tokens (not
    2048: each shard runs its own scans' host loop, so a step launches
    about M times the one-device step's kernels at the same tokens);
    whisper-medium whole on ``lm_train_encdec``'s shape (LM_BATCH x
    ENCDEC_S tokens over 1500 frames; 4 of its 16 heads a shard, the
    encoder not causal, both on ``flash_attention_sm90``). Then each in
    float32 and float64 against one device (``_tp_fp32_train``,
    ``_tp_fp32_serve``):
    zamba2 at its SSM_CHECK_LAYERS, xLSTM at one group, whisper at
    ENCDEC_CHECK_LAYERS + ENCDEC_CHECK_LAYERS, on CHECK_B rows of
    CHECK_S tokens (whisper's ENCDEC_S over 1500 frames). Returns the
    bf16 path's launches of each flash kernel, and the float32 checks'."""
    M = TP_SHARDS
    devices = place(M)
    mesh = make_host_mesh(M, devices)
    z = ARCHS[SSM_ARCH]
    zcfg = z.scaled(n_layers=SSM_CHECK_LAYERS)
    xcfg = ARCHS[XLSTM_ARCH]
    wcfg = ARCHS[ENCDEC_ARCH]
    frames = _frontend(torch, profile_serve, wcfg, 16)["frames"]
    cases = (
        ("zamba2", zcfg, STACKS_S, {}, zcfg.n_layers // zcfg.attn_every,
         "flash_attention_sm90", "flash_attention_bwd_sm90",
         zcfg.scaled(dtype="float32")),
        ("xlstm", xcfg, STACKS_S, {}, 0, None, None,
         xcfg.scaled(n_layers=xcfg.slstm_every, dtype="float32")),
        ("whisper", wcfg, ENCDEC_S, {"frames": frames},
         wcfg.n_layers + wcfg.n_enc_layers, "flash_attention_sm90",
         "flash_attention_bwd_sm90",
         wcfg.scaled(n_layers=ENCDEC_CHECK_LAYERS,
                     n_enc_layers=ENCDEC_CHECK_LAYERS, dtype="float32")))
    out, launches, launches32 = {}, _kernels(), _kernels()
    for tag, cfg, S, extra, n_attn, fwd, bwd, cfg32 in cases:
        B = LM_BATCH if cfg.enc_dec else TRAIN_B
        pipe = TokenPipeline(PipelineConfig(cfg.vocab, S, B))
        res = _tp_stack(torch, fa, kv, steps, adamw, SH, TP, mesh, devices,
                        cfg, S, lambda i: _batch(torch, pipe, i), extra,
                        n_attn, fwd, bwd, f"lm_tp_stacks {tag}")
        for k in launches:
            launches[k] += 2 * res["launches_per_step"][k] \
                + res["prefill_launches"][k]
        S32 = ENCDEC_S if cfg.enc_dec else CHECK_S
        b32 = _batch(torch, TokenPipeline(PipelineConfig(cfg.vocab, S32,
                                                         CHECK_B)), 0)
        if cfg.enc_dec:
            b32["frames"] = frames[:CHECK_B]
        n32 = (cfg32.n_layers + cfg32.n_enc_layers if cfg.enc_dec
               else cfg32.n_layers // max(cfg32.attn_every, 1)
               if cfg.block == "mamba2" else 0)
        want_one = _kernels(flash_attention_simt=2 * n32,
                            flash_attention_bwd=n32)
        want_tp = _kernels(flash_attention_simt=2 * n32 * M,
                           flash_attention_bwd=n32 * M)
        res["fp32_train_check"] = _tp_fp32_train(
            torch, fa, kv, steps, adamw, SH, TP, cfg32, mesh, b32, want_one,
            want_tp, f"lm_tp_stacks {tag}")
        res["fp32_serve_check"] = _tp_fp32_serve(
            torch, fa, kv, steps, adamw, SH, cfg32, mesh,
            {k: v for k, v in b32.items() if k != "labels"}, n32,
            f"lm_tp_stacks {tag}")
        for k in launches32:
            launches32[k] += want_one[k] + want_tp[k] + \
                res["fp32_serve_check"]["launches"][k]
        out[tag] = res
    del frames
    out["zamba2"]["layers_of"] = z.n_layers
    emit({"phase": "lm_tp_stacks", "card": smi,
          "call": "repro_torch.launch.steps.make_train_step(cfg, mesh), "
                  "make_serve_steps(cfg, mesh)",
          "mesh": dict(mesh.shape), "shards": _shards_on(devices),
          "cuts": {"zamba2": f"{zcfg.n_layers} of {z.n_layers} layers, "
                             f"{TRAIN_B} x {STACKS_S} tokens",
                   "xlstm": f"{TRAIN_B} x {STACKS_S} tokens",
                   "whisper": "none",
                   "fp32_checks": f"zamba2 {zcfg.n_layers} layers, xLSTM "
                                  f"{xcfg.slstm_every}, whisper "
                                  f"{ENCDEC_CHECK_LAYERS} + "
                                  f"{ENCDEC_CHECK_LAYERS}; {CHECK_B} x "
                                  f"{CHECK_S} tokens (whisper "
                                  f"{CHECK_B} x {ENCDEC_S})"},
          **out, "launches": launches, "fp32_launches": launches32})
    return launches, launches32


def phase_lm_serve_seq(torch, fa, kv, steps, ARCHS, SH, TP, make_host_mesh,
                       serve_logits, place=one_card):
    """qwen3-0.6b at full width served with ``REPRO_KV_SHARD=seq`` (set
    here and restored on the way out) over TP_SHARDS model shards (mesh
    (1, TP_SHARDS)): each shard holds every KV head of a quarter of the
    cache's slots, the prefill's attention runs each shard's query heads
    on ``flash_attention_sm90`` (a launch a layer a shard), and each
    decode step joins the shards' partial softmaxes on shard 0
    (``Group.join``, timed by CUDA events). ``lm_serve``'s params and
    prompts (seed 0, LM_BATCH x LM_PROMPT), SEQ_DECODE greedy steps; the
    prefill's bf16 logits beside ``lm_serve``'s (``serve_logits``; the
    params drawn into their blocks by ``SH.init_sharded``), and as
    close to the same weights' float32 one-device prefill as those are
    (the bf16 rule of ``tests/test_torch_ssm.py``: ``max |seq - f32| <= 2
    max |one - f32| + 2e-2 max |f32|``). In float32 at CHECK_LAYERS
    layers on CHECK_B x CHECK_S tokens: logits within 1e-5 of the
    one-device serve's max, LM_GREEDY_CHECK greedy tokens equal, each
    cache block its slot range of the one-device cache within 1e-5 of the
    leaf's max. Returns the bf16 run's ``flash_attention_sm90`` launches
    and the float32 launches of its checks (``flash_attention_simt``)."""
    prev = os.environ.get("REPRO_KV_SHARD")
    os.environ["REPRO_KV_SHARD"] = "seq"
    try:
        return _serve_seq(torch, fa, kv, steps, ARCHS, SH, TP,
                          make_host_mesh, serve_logits, place)
    finally:
        if prev is None:
            os.environ.pop("REPRO_KV_SHARD", None)
        else:
            os.environ["REPRO_KV_SHARD"] = prev


def _serve_seq(torch, fa, kv, steps, ARCHS, SH, TP, make_host_mesh,
               serve_logits, place):
    cfg = ARCHS[LM_ARCH]
    M = TP_SHARDS
    devices = place(M)
    mesh = make_host_mesh(M, devices)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(devices[0])
    _reset_peak(torch, devices)
    pr = SH.init_sharded(model, torch.Generator(
        device=devices[0]).manual_seed(0), SH.to_named(
        mesh, SH.param_specs(cfg, mesh, model.abstract_params())))
    m_f32, pre_f32, _ = steps.make_serve_steps(cfg.scaled(dtype="float32"),
                                                devices[0])
    p_f32 = SH.tree_map(lambda t, _: t.gather().float(), pr)
    fa.reset_counts()
    with torch.inference_mode():
        ref32 = pre_f32(p_f32, {"tokens": tokens}, m_f32.make_cache(
            LM_BATCH, LM_PROMPT))[0].float().cpu()
    ref32_launches = fa.COUNTS["flash_attention_simt"]
    del p_f32
    torch.cuda.empty_cache()
    ctx = LM_PROMPT + SEQ_DECODE
    cache = steps.shard_cache(cfg, mesh, model.make_cache(LM_BATCH, ctx))
    blk = cache["k"].blocks.flat[0]
    if (tuple(cache["k"].sharding.spec)[2] != "model"
            or blk.shape[2] != ctx // M or blk.shape[3] != cfg.n_kv_heads):
        raise AssertionError(f"lm_serve_seq: cache block {tuple(blk.shape)} "
                             f"of {cache['k']!r}")
    shard_bytes = sum(c.blocks.flat[0].numel() * c.blocks.flat[0]
                      .element_size() for c in (cache["k"], cache["v"]))
    want = _kernels(flash_attention_sm90=cfg.n_layers * M)

    def run():
        (logits, c), pre_s = _synced(torch, lambda: prefill(
            pr, {"tokens": tokens}, cache))
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

        def loop():
            t = tok
            for i in range(SEQ_DECODE):
                t, _ = decode(pr, t, c, LM_PROMPT + i)
            return t
        with TP.timed_collectives() as coll:
            last, dec_s = _synced(torch, loop)
        return logits, last, pre_s, dec_s, coll

    logits, last, prefill_s, decode_s, coll = _counted(
        fa, kv, run, want, "lm_serve_seq")
    peak = _peak(torch, devices)
    if (not bool(torch.isfinite(logits).all())
            or logits.shape != (LM_BATCH, 1, cfg.vocab)
            or int(last.min()) < 0 or int(last.max()) >= cfg.vocab):
        raise AssertionError("lm_serve_seq gave non-finite logits or bad "
                             "tokens")
    vs_one = float((logits.float().cpu() - serve_logits).abs().max())
    scale = float(serve_logits.abs().max())
    argmax_equal = int((torch.argmax(logits.float().cpu()[:, -1], -1)
                        == torch.argmax(serve_logits[:, -1], -1)).sum())
    seq_f32 = float((logits.float().cpu() - ref32).abs().max())
    one_f32 = float((serve_logits - ref32).abs().max())
    bound16 = 2 * one_f32 + 2e-2 * float(ref32.abs().max())
    join = coll.get("join", {"calls": 0, "ms": 0.0})
    if (join["calls"] != cfg.n_layers * SEQ_DECODE or seq_f32 > bound16
            or ref32_launches != cfg.n_layers):
        raise AssertionError(f"lm_serve_seq: {join['calls']} joins, bf16 "
                             f"logits {seq_f32} from float32's (bound "
                             f"{bound16}), {ref32_launches} float32 launches")
    del pr, cache, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    m1, pre1, dec1 = steps.make_serve_steps(cfg32, devices[0])
    _, pre_tp, dec_tp = steps.make_serve_steps(cfg32, mesh)
    p32 = m1.init(torch.Generator(device=devices[0]).manual_seed(1))
    toks32 = {"tokens": torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (CHECK_B, CHECK_S))).to(devices[0])}
    ctx32 = CHECK_S + LM_GREEDY_CHECK
    c1 = m1.make_cache(CHECK_B, ctx32)
    l1, t1 = _tp_greedy(torch, pre1, dec1, p32, toks32, c1, LM_GREEDY_CHECK,
                        CHECK_S)
    P32 = SH.shard_tree(p32, SH.to_named(mesh, SH.param_specs(cfg32, mesh,
                                                              p32)))
    ct = steps.shard_cache(cfg32, mesh, m1.make_cache(CHECK_B, ctx32))
    fa.reset_counts()
    lt, tt = _tp_greedy(torch, pre_tp, dec_tp, P32, toks32, ct,
                        LM_GREEDY_CHECK, CHECK_S)
    launches32 = fa.COUNTS["flash_attention_simt"]
    err = float((lt - l1).abs().max())
    scale32 = float(l1.abs().max())
    cache_err = 0.0
    for k in ("k", "v"):
        whole = c1[k]
        for pos in np.ndindex(ct[k].blocks.shape):
            sl = ct[k].sharding.block(ct[k].shape, pos)
            cache_err = max(cache_err, float(
                (ct[k].blocks[pos] - whole[sl]).abs().max())
                / float(whole.abs().max()))
    if (err > 1e-5 * scale32 or not torch.equal(tt, t1)
            or launches32 != CHECK_LAYERS * M or cache_err > 1e-5):
        raise AssertionError(
            f"float32 seq-sharded serve != one-device serve: logits {err} "
            f"of {scale32}, tokens {tt.tolist()} vs {t1.tolist()}, "
            f"{launches32} flash_attention_simt launches, cache blocks "
            f"{cache_err} of the leaf's max")
    del p32, P32, c1, ct
    torch.cuda.empty_cache()
    launches = want["flash_attention_sm90"]
    launches32 += ref32_launches
    emit({"phase": "lm_serve_seq", "arch": LM_ARCH,
          "call": f"REPRO_KV_SHARD=seq repro_torch.launch.steps."
                  f"make_serve_steps(ARCHS['{LM_ARCH}'], make_host_mesh("
                  f"{M}, {[str(d) for d in devices]}))",
          "mesh": dict(mesh.shape), "shards": _shards_on(devices),
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "B": LM_BATCH, "S": LM_PROMPT, "ctx": ctx,
          "cache_block_shape": list(blk.shape),
          "cache_bytes_a_shard": shard_bytes,
          "decode_steps": SEQ_DECODE,
          "flash_attention_sm90_launches_per_prefill": launches,
          "prefill_s": prefill_s,
          "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
          "decode_s": decode_s,
          "decode_tokens_per_s": LM_BATCH * SEQ_DECODE / decode_s,
          "join": {**join, "ms_a_step": join["ms"] / SEQ_DECODE},
          "peak_memory_bytes": peak,
          "bf16_logits_vs_lm_serve": {
              "max_abs_diff": vs_one, "max_abs_one_device": scale,
              "rows_with_the_same_argmax": argmax_equal},
          "bf16_logits_vs_float32": {
              "seq_max_abs_diff": seq_f32, "lm_serve_max_abs_diff": one_f32,
              "bound": bound16,
              "flash_attention_simt_launches": ref32_launches},
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "ctx": ctx32,
                         "flash_attention_simt_launches": launches32,
                         "logits_max_abs_err": err,
                         "logits_max_abs": scale32,
                         "cache_block_err_over_leaf_max": cache_err,
                         "greedy_tokens_equal": LM_GREEDY_CHECK}})
    return launches, launches32


CONFIG_ARCHS = ("starcoder2-3b", "qwen3-1.7b")   # lm_configs' models
CONFIG_DECODE = 8          # their greedy steps
CONFIG_TIMED = 1           # their timed train steps, after a warm-up


def phase_lm_configs(torch, fa, kv, flash_ref, steps, L, ARCHS, adamw,
                     TokenPipeline, PipelineConfig, smi):
    """starcoder2-3b (GELU MLP, QKV bias, 24 query heads over 2 KV heads:
    G 12) and qwen3-1.7b (qk-norm, G 2) at full width and depth in bf16,
    weights random from a seed. Each served through ``make_serve_steps``
    (``_serve``: LM_BATCH prompts of LM_PROMPT tokens, a counted prefill
    of one ``flash_attention_sm90`` launch a layer and CONFIG_DECODE
    greedy steps, a timed prefill and the decode loop again), with
    ``_fp32_checks`` at CHECK_LAYERS layers; then trained through
    ``make_train_step`` (``_train_model``: a warm-up and CONFIG_TIMED
    timed steps of TRAIN_B x TRAIN_S tokens from ``TokenPipeline``, each
    2 x L ``flash_attention_sm90`` (the forward and its recompute) and L
    ``flash_attention_bwd_sm90``, nothing else), the peak beside a
    reckoning (``_train_reckoning`` and the fp32 logits and their
    gradient), with ``_fp32_train_check`` at CHECK_LAYERS layers. Returns
    the bf16 paths' launches of each flash kernel, the float32 checks',
    and the bf16 paths' of each model."""
    out, launches, launches32, by_model = {}, _kernels(), _kernels(), {}
    ntok = TRAIN_B * TRAIN_S
    for i, name in enumerate(CONFIG_ARCHS):
        cfg = ARCHS[name]
        ctx = LM_PROMPT + CONFIG_DECODE
        tokens, serve = _serve(torch, fa, kv, steps, cfg, 20 + i,
                               CONFIG_DECODE, ctx,
                               {"flash_attention_sm90": cfg.n_layers},
                               repeats=1)
        serve.update(_fp32_checks(torch, fa, flash_ref, steps, L,
                                  cfg.scaled(n_layers=CHECK_LAYERS),
                                  tokens, ctx), fp32_check_layers=CHECK_LAYERS)
        del tokens
        pipe = TokenPipeline(PipelineConfig(cfg.vocab, TRAIN_S, TRAIN_B))
        want = _kernels(flash_attention_sm90=2 * cfg.n_layers,
                        flash_attention_bwd_sm90=cfg.n_layers)
        train = _train_model(torch, fa, kv, steps, adamw, cfg,
                             lambda j: _batch(torch, pipe, j), want,
                             CONFIG_TIMED, f"lm_configs {name}")
        rk = train["memory_reckoning_bytes"]
        del rk["total"]
        rk.update(fp32_logits=4 * ntok * cfg.vocab,
                  fp32_logits_grad=4 * ntok * cfg.vocab)
        rk["total"] = sum(rk.values())
        want32 = _kernels(flash_attention_simt=2 * CHECK_LAYERS,
                          flash_attention_bwd=CHECK_LAYERS)
        pipe32 = TokenPipeline(PipelineConfig(cfg.vocab, CHECK_S, CHECK_B))
        check = _fp32_train_check(
            torch, fa, kv, flash_ref, steps, L, adamw,
            cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32"),
            _batch(torch, pipe32, 0), want32, f"lm_configs {name}")
        train.update(B=TRAIN_B, S=TRAIN_S, tokens_per_step=ntok,
                     tokens_per_s=[ntok / t for t in train["step_s"]],
                     fp32_check={**check, "B": CHECK_B, "S": CHECK_S})
        by_model[name] = {k: serve["launches_per_run"].get(k, 0)
                          + want[k] * (1 + CONFIG_TIMED) for k in want}
        for k in launches:
            launches[k] += by_model[name][k]
            launches32[k] += want32[k]
        launches32["flash_attention_simt"] += \
            serve["fp32_flash_attention_simt_launches_per_prefill"]
        out[name] = {"G": cfg.n_heads // cfg.n_kv_heads,
                     "param_count": list(cfg.param_count()),
                     "serve": serve, "train": train}
    emit({"phase": "lm_configs", "card": smi,
          "call": "repro_torch.launch.steps.make_serve_steps(cfg), "
                  "make_train_step(cfg)", **out, "launches": launches,
          "fp32_launches": launches32})
    return launches, launches32, by_model


BIG_ARCH, BIG_LAYERS = "qwen1.5-110b", 20   # lm_serve_big on one card
BIG_DECODE = 8             # its greedy steps
BIG_SEEDS = {"qwen1.5-110b": 30, "qwen2-vl-72b": 31, "mixtral-8x7b": 32}


def _nbytes(t) -> int:
    return t.shape.numel() * t.dtype.itemsize


def _big_reckoning(torch, SH, cfg, shapes, pr, cache, devices) -> dict:
    """Bytes on each device, from the shapes and the blocks: its blocks
    of the params (``param_specs``) and its share of the cache
    (``cache_specs``). On the draw device (shard 0's) the init also holds
    one drawn layer (its leaves in the config's dtype beside its largest
    leaf's fp32 draw) while every block of the stack is allocated, and,
    before any stack's blocks exist, one embedding leaf's fp32 draw
    beside its cast; a run also the whole cache ``make_cache`` makes there
    before ``shard_cache`` places it. Activations are not reckoned."""
    leaves, blocks = SH.tree_leaves(pr), SH.tree_leaves(cache)
    per = {}
    for pos in np.ndindex(leaves[0].blocks.shape):
        r = per.setdefault(str(leaves[0].blocks[pos].device),
                           {"param_blocks": 0, "cache_share": 0})
        r["param_blocks"] += sum(_nbytes(t.blocks[pos]) for t in leaves)
        r["cache_share"] += sum(_nbytes(t.blocks[pos]) for t in blocks)
    stacked = SH.tree_leaves(shapes["layers"])
    n = cfg.n_layers
    r0 = per[str(torch.device(devices[0]))]
    r0["drawn_layer"] = sum(_nbytes(t) // n for t in stacked) \
        + 4 * max(t.shape.numel() // n for t in stacked)
    r0["embedding_leaf_draw"] = max(
        t.shape.numel() * (4 + t.dtype.itemsize)
        for t in SH.tree_leaves(shapes["embed"]))
    r0["whole_cache_before_placing"] = sum(_nbytes(t) for t in blocks)
    for r in per.values():
        r["init_total"] = r["param_blocks"] + r.get("drawn_layer", 0)
        r["run_total"] = r["param_blocks"] + r["cache_share"] + r.get(
            "whole_cache_before_placing", 0)
    return per


def phase_lm_serve_big(torch, fa, kv, steps, ARCHS, SH, make_host_mesh,
                       profile_serve, smi, arch=BIG_ARCH, n_layers=BIG_LAYERS,
                       place=one_card):
    """``arch`` at full width and ``n_layers`` of its layers (None: all)
    served over TP_SHARDS model shards (mesh (1, TP_SHARDS); ``place``: of
    card 0, or one a card) through ``make_serve_steps(cfg, mesh)`` in
    bf16, its parameters drawn straight into their blocks
    (``SH.init_sharded``, seed ``BIG_SEEDS[arch]``: no device holds the
    model whole); LM_BATCH prompts of LM_PROMPT tokens (after qwen2-vl's
    VLM_PATCHES patches), a counted prefill (one ``flash_attention_sm90``
    launch a layer a shard, each shard's query heads over its KV heads)
    and BIG_DECODE greedy steps, then a timed prefill and the decode loop
    again; the init's seconds, and the init's and the run's peak on each
    device beside ``_big_reckoning``. In float32 at CHECK_LAYERS layers
    on the same mesh, CHECK_B x CHECK_S tokens (after CHECK_B rows of
    patches), drawn the same way: the prefill's logits within 1e-4 of the
    one-device serve's (its params from ``model.init``) and
    LM_GREEDY_CHECK greedy tokens equal. Returns the bf16 run's
    ``flash_attention_sm90`` launches and the float32 check's
    ``flash_attention_simt`` launches."""
    full = ARCHS[arch]
    cfg = full if n_layers is None else full.scaled(n_layers=n_layers)
    M = TP_SHARDS
    devices = place(M)
    mesh = make_host_mesh(M, devices)
    seed = BIG_SEEDS[arch]
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    extra = {} if cfg.family != "vlm" else {
        k: v.to(devices[0]) for k, v in _frontend(
            torch, profile_serve, cfg, seed).items()}
    n_pre = extra["patches"].shape[1] if extra else 0
    tokens = torch.from_numpy(np.random.default_rng(seed + 13).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(devices[0])
    batch = {"tokens": tokens, **extra}
    start = n_pre + LM_PROMPT
    shapes = model.abstract_params()
    specs = SH.param_specs(cfg, mesh, shapes)
    _reset_peak(torch, devices)
    base = {str(d): torch.cuda.memory_allocated(d) for d in set(devices)}
    pr, init_s = _synced(torch, lambda: SH.init_sharded(
        model, torch.Generator(device=devices[0]).manual_seed(seed),
        SH.to_named(mesh, specs)))
    init_peak = _peak(torch, devices)
    _reset_peak(torch, devices)
    ctx = start + BIG_DECODE
    cache = steps.shard_cache(cfg, mesh, model.make_cache(LM_BATCH, ctx))
    want = _kernels(flash_attention_sm90=cfg.n_layers * M)

    def run():
        return _tp_greedy(torch, prefill, decode, pr, batch, cache,
                          BIG_DECODE + 1, start)

    (logits, gen), first_s = _synced(torch, lambda: _counted(
        fa, kv, run, want, f"lm_serve_big {arch}"))
    if (not bool(torch.isfinite(logits).all())
            or logits.shape != (LM_BATCH, 1, cfg.vocab)
            or gen.shape != (LM_BATCH, BIG_DECODE + 1)
            or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab):
        raise AssertionError(f"lm_serve_big {arch} gave non-finite logits "
                             "or bad tokens")
    _, prefill_s = _synced(torch, lambda: prefill(pr, batch, cache))
    tok = gen[:, :1]

    def loop():
        t = tok
        for i in range(BIG_DECODE):
            t, _ = decode(pr, t, cache, start + i)

    _, decode_s = _synced(torch, loop)
    run_peak = _peak(torch, devices)
    reckoning = _big_reckoning(torch, SH, cfg, shapes, pr, cache, devices)
    del pr, cache, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    m1, pre1, dec1 = steps.make_serve_steps(cfg32, devices[0])
    mt, pre_tp, dec_tp = steps.make_serve_steps(cfg32, mesh)
    b32 = {"tokens": torch.from_numpy(np.random.default_rng(
        seed + 14).integers(0, cfg.vocab, (CHECK_B, CHECK_S))).to(
        devices[0]), **{k: v[:CHECK_B] for k, v in extra.items()}}
    start32 = n_pre + CHECK_S
    ctx32 = start32 + LM_GREEDY_CHECK
    p32 = m1.init(torch.Generator(device=devices[0]).manual_seed(1))
    l1, t1 = _tp_greedy(torch, pre1, dec1, p32, b32, m1.make_cache(
        CHECK_B, ctx32), LM_GREEDY_CHECK, start32)
    del p32
    P32 = SH.init_sharded(mt, torch.Generator(device=devices[0]).manual_seed(
        1), SH.to_named(mesh, SH.param_specs(cfg32, mesh,
                                             mt.abstract_params())))
    fa.reset_counts()
    lt, tt = _tp_greedy(torch, pre_tp, dec_tp, P32, b32, steps.shard_cache(
        cfg32, mesh, m1.make_cache(CHECK_B, ctx32)), LM_GREEDY_CHECK,
        start32)
    launches32 = fa.COUNTS["flash_attention_simt"]
    err = float((lt - l1).abs().max())
    if (err > 1e-4 or not torch.equal(tt, t1)
            or launches32 != CHECK_LAYERS * M):
        raise AssertionError(
            f"float32 lm_serve_big {arch} != one-device serve: logits "
            f"{err}, tokens {tt.tolist()} vs {t1.tolist()}, {launches32} "
            "flash_attention_simt launches")
    del P32, b32, extra, batch
    torch.cuda.empty_cache()
    n_params = sum(t.shape.numel() for t in SH.tree_leaves(shapes))
    emit({"phase": "lm_serve_big", "card": smi, "arch": arch,
          "call": f"repro_torch.launch.steps.make_serve_steps(ARCHS"
                  f"['{arch}'], make_host_mesh({M}, "
                  f"{[str(d) for d in devices]})), params from "
                  "repro_torch.distributed.sharding.init_sharded",
          "mesh": dict(mesh.shape), "shards": _shards_on(devices),
          "label": (f"{M} model shards of one card: shards run in turn, no "
                    "copies between cards" if len(set(map(str, devices)))
                    == 1 else "one model shard a card"),
          "n_layers": cfg.n_layers, "layers_of": full.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
          "param_bytes": sum(_nbytes(t) for t in SH.tree_leaves(shapes)),
          "full_depth_param_count_x2_bytes": 2 * full.param_count()[0],
          "dtype": cfg.dtype,
          "heads_a_shard": [cfg.n_heads // M, cfg.n_kv_heads // M],
          "experts_a_shard": cfg.n_experts // M if cfg.is_moe else None,
          "B": LM_BATCH, "S": LM_PROMPT, "patches": n_pre, "ctx": ctx,
          "decode_steps": BIG_DECODE,
          "flash_attention_sm90_launches_per_prefill": want[
              "flash_attention_sm90"],
          "init_s": init_s, "first_run_s": first_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
          "decode_s": decode_s,
          "decode_tokens_per_s": LM_BATCH * BIG_DECODE / decode_s,
          "base_bytes": base, "init_peak_bytes": init_peak,
          "run_peak_bytes": run_peak, "memory_reckoning_bytes": reckoning,
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "mesh": dict(mesh.shape),
                         "flash_attention_simt_launches": launches32,
                         "logits_max_abs_err": err,
                         "greedy_tokens_equal": LM_GREEDY_CHECK}})
    return want["flash_attention_sm90"], launches32


DRY_TRAIN_B, DRY_TRAIN_S = 2, 4096      # the planned-then-run train step
DRY_PREFILL_B, DRY_PREFILL_S = 1, 32768  # the planned-then-run prefill
DRY_PEAK_TOL = 0.05                     # planned peak against measured
# planned (not run), each must plan: one cell a stack kind on the 16x16
# mesh, and every long_500k cell (a batch of 1, which the data axis
# replicates) on both production meshes; (arch, shape, multi_pod)
DRY_CELLS = (("qwen3-0.6b", "train_4k", False),
             ("deepseek-moe-16b", "prefill_32k", False),
             ("whisper-medium", "decode_32k", False),
             ("qwen1.5-110b", "train_4k", False),
             *((arch, "long_500k", mp) for mp in (False, True)
               for arch in ("zamba2-7b", "mixtral-8x7b", "xlstm-125m")))


def _dry_cell(job):
    """Worker: one production cell planned on meta devices."""
    from repro_torch.launch import dryrun as DR
    return DR._one((*job, False, True))


def _bound_ms(DR, counts, mf=0.0) -> float:
    return DR.roofline(counts, 1, mf).step_time * 1e3


def _measured_peak(torch, base: int, planned: int, tag: str) -> dict:
    """The card's peak above ``base`` beside the planned peak; raises
    past DRY_PEAK_TOL."""
    peak = torch.cuda.max_memory_allocated() - base
    rel = abs(planned - peak) / peak
    if not rel <= DRY_PEAK_TOL:
        raise AssertionError(f"{tag}: planned peak {planned} bytes, "
                             f"measured {peak} ({rel:.3f} apart)")
    return {"planned_peak_bytes": planned, "measured_peak_bytes": peak,
            "peak_rel_err": rel}


def _dry_flash(torch, fa, flash_ref, cfg) -> dict:
    """The flash forward at the dry-run prefill's shape (BH 16, S 32768,
    dh 128, causal) against ``flash_ref`` in float32 on two heads, each
    row within FLASH_ROW_TOL of its size; and the same check given a
    planted fault (each row past S/2 blind to the keys past S/2), which it
    must fail. Launches made to compare do not count."""
    H, Hkv, dh, S = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, DRY_PREFILL_S
    q, k, v = flash_inputs(torch, DRY_PREFILL_B * H, DRY_PREFILL_B * Hkv, S,
                           dh, "bfloat16", 97)
    o = fa.flash_attention_sm90(q, k, v, True)[:2].clone()
    g = H // Hkv
    q, k, v = q[:2].float(), k[:2 // g].float(), v[:2 // g].float()
    want = flash_ref(q, k, v, True)
    err = flash_row_err(o, want)
    half = S // 2
    bad = o.float()
    bad[:, half:] = flash_ref(q[:, half:], k[:, :half], v[:, :half], False)
    planted = flash_row_err(bad, want)
    abs_err = float((o.float() - want).abs().max())
    torch.cuda.synchronize()
    tol = FLASH_ROW_TOL["bfloat16"]
    if not err <= tol:
        raise AssertionError(f"flash_attention_sm90 at S {S}: a row {err} "
                             "of its size from flash_ref")
    if not planted > tol:
        raise AssertionError(f"flash at S {S}: the check passes a planted "
                             f"fault (a row {planted} of its size off)")
    del q, k, v, o, want, bad
    torch.cuda.empty_cache()
    return {"BH": DRY_PREFILL_B * H, "BHkv": DRY_PREFILL_B * Hkv, "S": S,
            "dh": dh, "heads_checked": 2, "row_rel_err": err,
            "row_tol": tol, "planted_fault_row_rel_err": planted,
            "max_abs_err": abs_err}


def _planned(DR, cfg, mode, S, B) -> tuple:
    """(plan counts, planned launches, plan record) of a step on one
    device."""
    tp0 = time.perf_counter()
    plan = DR.plan(cfg, mode, S, B)
    counts = plan["counts"]
    return counts, {k[1]: int(v) for k, v in counts.items()
                    if k[0] == "launch"}, {
        "B": B, "S": S, "plan_s": time.perf_counter() - tp0,
        "traces": plan["traces"], "bound_ms": _bound_ms(DR, counts)}


def phase_dryrun(torch, fa, kv, flash_ref, steps, ARCHS, adamw, smi):
    """The dry run (``launch/dryrun.py``) held to the card. qwen3-0.6b
    whole in bf16: the flash forward at the prefill's shape against
    ``flash_ref`` (``_dry_flash``); a prefill of DRY_PREFILL_B x
    DRY_PREFILL_S tokens and a train step of DRY_TRAIN_B x DRY_TRAIN_S on
    one device, each planned on meta tensors, then run: the planned flash
    launches equal ``COUNTS``, the planned peak is within DRY_PEAK_TOL of
    ``max_memory_allocated`` above the base before it, the logits are
    finite; the step's planned FLOPs equal ``FlopCounterMode`` over the
    real step, its loss and gradient norm finite. Meanwhile DRY_CELLS are
    planned in worker processes, each to a record, and each must plan. The
    prefill and the step are timed after the workers have
    ended, on an otherwise idle host, each planned bound beside its time.
    Returns the flash launches of the two real runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    cfg = ARCHS[LM_ARCH]
    out = {"arch": LM_ARCH, "nvidia_smi": smi}
    launches = {}
    workers = max(1, min(len(DRY_CELLS), (os.cpu_count() or 2) - 1))
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as pool:
        cells = [pool.submit(_dry_cell, c) for c in DRY_CELLS]
        torch.cuda.empty_cache()
        out["flash_s32768"] = _dry_flash(torch, fa, flash_ref, cfg)
        g = torch.Generator(device="cuda").manual_seed(5)

        # the prefill: planned, then run (its state kept for the timing)
        base = torch.cuda.memory_allocated()
        counts, planned, rec = _planned(DR, cfg, "prefill", DRY_PREFILL_S,
                                        DRY_PREFILL_B)
        model, prefill, _ = steps.make_serve_steps(cfg)
        sparams = model.init(torch.Generator(device="cuda").manual_seed(0))
        cache = model.make_cache(DRY_PREFILL_B, DRY_PREFILL_S)
        tokens = torch.randint(0, cfg.vocab, (DRY_PREFILL_B, DRY_PREFILL_S),
                               generator=g, device="cuda",
                               dtype=torch.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, _ = _counted(fa, kv, lambda: prefill(
            sparams, {"tokens": tokens}, cache), planned, "dryrun prefill")
        torch.cuda.synchronize()
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("dryrun prefill: logits not finite")
        out["prefill"] = {**rec, "launches": planned, **_measured_peak(
            torch, base, int(counts[("dev", 0, "peak")]), "dryrun prefill")}
        launches["prefill"] = planned
        del logits, model

        # the train step: planned, then run
        base = torch.cuda.memory_allocated()
        counts, planned, rec = _planned(DR, cfg, "train", DRY_TRAIN_S,
                                        DRY_TRAIN_B)
        model, step, _, _ = steps.make_train_step(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        opt = adamw.init(params)
        batch = {k: torch.randint(0, cfg.vocab, (DRY_TRAIN_B, DRY_TRAIN_S),
                                  generator=g, device="cuda",
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            _, _, metrics = _counted(fa, kv, lambda: step(params, opt, batch),
                                     planned, "dryrun train step")
        torch.cuda.synchronize()
        flops = fc.get_total_flops()
        if int(counts[("dev", 0, "flops")]) != flops:
            raise AssertionError(f"dryrun train step: planned "
                                 f"{counts[('dev', 0, 'flops')]} FLOPs, "
                                 f"counted {flops}")
        loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
        if not (np.isfinite([loss, gnorm]).all() and gnorm > 0):
            raise AssertionError(f"dryrun train step: loss {loss}, gnorm "
                                 f"{gnorm}")
        out["train"] = {**rec, "flops": flops, "launches": planned,
                        "loss": loss, "gnorm": gnorm, **_measured_peak(
                            torch, base, int(counts[("dev", 0, "peak")]),
                            "dryrun train step")}
        launches["train"] = planned
        del metrics, model

        # the production cells, planned in the workers
        out["cells"] = []
        for (arch, shape, _), fut in zip(DRY_CELLS, cells):
            _, rec = fut.result()
            if rec["status"] != "ok":
                raise AssertionError(f"dryrun {arch} {shape} "
                                     f"{rec['mesh']}: {rec['error']}")
            r = rec["roofline"]
            out["cells"].append({
                "arch": arch, "shape": shape, "mesh": rec["mesh"],
                "status": "ok", "t_trace_s": rec["t_trace_s"],
                "peak_bytes": rec["memory"]["peak_bytes"],
                "bottleneck": r["bottleneck"],
                "bound_ms": 1e3 * max(r["t_compute"], r["t_memory"],
                                      r["t_collective"]),
                "t_compute": r["t_compute"], "t_memory": r["t_memory"],
                "t_collective": r["t_collective"],
                "roofline_fraction": r["roofline_fraction"],
                "calibration": rec["calibration"],
                "measured": f"not run: {rec['n_chips']} cards",
                "nvidia_smi": smi})
    # the workers have ended: the step and the prefill timed on an idle host
    out["train"].update(ms=cuda_ms(torch, lambda: step(params, opt, batch),
                                   1, warm=1), nvidia_smi=smi)
    del params, opt, batch, step
    torch.cuda.empty_cache()
    out["prefill"].update(ms=cuda_ms(torch, lambda: prefill(
        sparams, {"tokens": tokens}, cache), 1, warm=1), nvidia_smi=smi)
    del sparams, cache, tokens, prefill
    torch.cuda.empty_cache()
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t0, **out})
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def time_flash(torch, fa, flash_ref):
    """Both flash kernels at the qwen3-0.6b prefill's shape (bf16, causal,
    GQA G=2), timed in one call in turns (tensor-core kernel, the same
    saving lse as training runs it, CUDA-core kernel, plain version, SDPA,
    then the same in reverse): CUDA-event ms, the bound they share, and
    one PyTorch call computing the same function (SDPA, the yardstick; the
    port never calls it)."""
    import torch.nn.functional as F
    BH, BHkv, S, dh = LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, 128
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, "bfloat16", 99)
    B = LM_BATCH
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh) for t in (q, k, v))
    library = "scaled_dot_product_attention(is_causal, enable_gqa)"
    out = {}

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    def run(name, fn):
        def launch():
            out[name] = fn(q, k, v)
        return launch

    def sm90_lse(q, k, v):
        return fa.flash_attention_sm90(q, k, v, return_lse=True)[0]

    fns = {"flash_attention_sm90": (run("flash_attention_sm90",
                                        fa.flash_attention_sm90), 20, 3),
           "sm90_lse": (run("sm90_lse", sm90_lse), 20, 3),
           "flash_attention_simt": (run("flash_attention_simt",
                                        fa.flash_attention_simt), 5, 1),
           "plain": (run("plain", flash_ref), 3, 1),
           "library": (sdpa, 20, 3)}
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    # each input read once, the output written once; causal score and
    # P V products: 2 x (BH S^2 dh / 2) multiply-adds
    nbytes = 2 * (2 * BH * S * dh + 2 * BHkv * S * dh)
    flops = 2 * BH * S * S * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    common = {"case": f"BH={BH} BHkv={BHkv} S={S} dh={dh} bf16 causal",
              "plain_ms": ms["plain"], "plain_ms_turns": turns["plain"],
              "library_ms": ms["library"],
              "library_ms_turns": turns["library"], "library": library,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "bytes": nbytes, "flops": flops}
    res = {}
    for name in ("flash_attention_sm90", "flash_attention_simt"):
        err = float((out[name].float() - out["plain"].float()).abs().max())
        if err > FLASH_TOL["bfloat16"] * 4:
            raise AssertionError(f"timed {name} != plain ({err})")
        res[name] = {**common, "ms": ms[name], "ms_turns": turns[name],
                     "max_abs_err": err,
                     "tflops_per_s": flops / ms[name] * 1e-9}
    if not torch.equal(out["sm90_lse"], out["flash_attention_sm90"]):
        raise AssertionError("flash_attention_sm90 saving lse gave another "
                             "output")
    res["flash_attention_sm90"].update(ms_with_lse=ms["sm90_lse"],
                                       ms_with_lse_turns=turns["sm90_lse"])
    return res


def _time_flash_case(torch, fa, flash_ref, BH, BHkv, S, dh, causal, seed,
                     earlier=False, plain_heads=None):
    """The kernel ``route`` picks for bf16 at ``dh``, at (BH, BHkv, S, dh,
    causal), timed in one call in turns with the plain version and SDPA
    (kernel, plain, SDPA, then in reverse): CUDA-event ms and the bound at
    the bf16 tensor-core rate (score and P V products: 2 x BH S^2 dh
    multiply-adds, half of them when causal). The kernel's output is held
    to the plain version's within FLASH_TOL and, at its worst row, within
    FLASH_ROW_TOL of the row's norm. With ``earlier``, also
    ``flash_attention_simt`` (the 3xTF32 kernel that ran the shape
    before), called directly in the same turns and held to the plain
    version too (``earlier_ms``). With ``plain_heads``, the plain version
    runs on the first ``plain_heads`` query row-sets and their key/value
    row-sets only (its S x S scores over every head would not fit the
    card), the kernel is held to it there, and ``plain_ms`` is its time on
    those heads."""
    import torch.nn.functional as F
    kernel = fa.route(torch.bfloat16, dh)
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, "bfloat16", seed)
    q4, k4, v4 = (t.view(LM_BATCH, t.shape[0] // LM_BATCH, S, dh)
                  for t in (q, k, v))
    ph = plain_heads or BH
    qp, kp, vp = q[:ph], k[:ph // (BH // BHkv)], v[:ph // (BH // BHkv)]
    out = {}

    def run(name, fn):
        def launch():
            out[name] = fn(q, k, v, causal)
        return launch

    def plain():
        out["plain"] = flash_ref(qp, kp, vp, causal)

    fast = kernel == "flash_attention_sm90"
    fns = {"kernel": (run("kernel", getattr(fa, kernel)),
                      20 if fast else 5, 3 if fast else 1),
           "plain": (plain, 3, 1),
           "library": (lambda: F.scaled_dot_product_attention(
               q4, k4, v4, is_causal=causal, enable_gqa=BH != BHkv), 20, 3)}
    if earlier:
        fns["earlier"] = (run("earlier", fa.flash_attention_simt), 5, 1)
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    errs = {name: float((out[name][:ph].float() - out["plain"].float())
                        .abs().max()) for name in ("kernel", "earlier")
            if name in out}
    err = errs["kernel"]
    tag = (f"BH={BH} BHkv={BHkv} S={S} dh={dh} bf16 "
           f"{'causal' if causal else 'not causal'}")
    rows = {name: flash_row_err(out[name][:ph], out["plain"])
            for name in errs}
    for name, e in errs.items():
        if e > FLASH_TOL["bfloat16"] or not (
                rows[name] <= FLASH_ROW_TOL["bfloat16"]):
            who = kernel if name == "kernel" else "flash_attention_simt"
            raise AssertionError(f"timed {who} at {tag} != plain ({e}; "
                                 f"worst row {rows[name]} of its norm)")
    nbytes = 2 * (2 * BH * S * dh + 2 * BHkv * S * dh)
    flops = (2 if causal else 4) * BH * S * S * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    row = {"case": tag, "kernel": kernel,
           "ms": ms["kernel"], "ms_turns": turns["kernel"],
           "plain_ms": ms["plain"], "plain_ms_turns": turns["plain"],
           "library_ms": ms["library"], "library_ms_turns": turns["library"],
           "library": "scaled_dot_product_attention(is_causal="
           f"{causal}{', enable_gqa' if BH != BHkv else ''})",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "max_abs_err": err,
           "row_rel_err": rows["kernel"],
           "tflops_per_s": flops / ms["kernel"] * 1e-9}
    if plain_heads:
        row["plain_heads"] = plain_heads
    if earlier:
        row.update(earlier_kernel="flash_attention_simt",
                   earlier_ms=ms["earlier"],
                   earlier_ms_turns=turns["earlier"],
                   earlier_max_abs_err=errs["earlier"],
                   earlier_tflops_per_s=flops / ms["earlier"] * 1e-9)
    return row


def time_flash_zamba2(torch, fa, flash_ref):
    """``flash_attention_sm90`` at zamba2-7b's prefill shape (BH = BHkv =
    128, S = 2048, dh = 112, bf16, causal; the route for bf16 at dh 112,
    on zero columns up to 128), by ``_time_flash_case``, beside
    ``flash_attention_simt`` (the 3xTF32 kernel that ran this shape
    before) called directly in the same turns."""
    return _time_flash_case(torch, fa, flash_ref, LM_BATCH * 32,
                            LM_BATCH * 32, LM_PROMPT, 112, True, 98,
                            earlier=True)


def time_flash_encdec(torch, fa, flash_ref):
    """``flash_attention_sm90`` at whisper-medium's encoder shape (BH =
    BHkv = 64, S = 1500, dh = 64, not causal) and at qwen2-vl-72b's
    prefill (BH 256 over BHkv 32, G 8, S 2304, dh 128, causal), each by
    ``_time_flash_case``."""
    return {"whisper_encoder": _time_flash_case(
                torch, fa, flash_ref, LM_BATCH * 16, LM_BATCH * 16, 1500, 64,
                False, 97),
            "qwen2_vl_prefill": _time_flash_case(
                torch, fa, flash_ref, LM_BATCH * 64, LM_BATCH * 8,
                VLM_PATCHES + LM_PROMPT, 128, True, 96)}


def time_flash_fp32(torch, fa, flash_ref):
    """``flash_attention_simt`` on its own path's type: float32 at the
    serving shape (causal, GQA G=2), without lse (as the prefill runs it)
    and saving it (as training runs it), timed in one call in turns with
    the plain version and float32 SDPA (kernel, kernel with lse, plain,
    SDPA, then the same in reverse), against two bounds: the causal
    products at the card's float32 rate outside the tensor cores
    (``bound_ms``), and the three TF32 products of each in 3xTF32 at the
    tensor cores' TF32 rate (``bound_3xtf32_ms``)."""
    import torch.nn.functional as F
    BH, BHkv, S, dh = LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, 128
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, "float32", 98)
    B = LM_BATCH
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh) for t in (q, k, v))
    out = {}

    def run(name, fn):
        def launch():
            out[name] = fn(q, k, v)
        return launch

    def with_lse(q, k, v):
        return fa.flash_attention_simt(q, k, v, return_lse=True)[0]

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    fns = {"flash_attention_simt": (run("flash_attention_simt",
                                        fa.flash_attention_simt), 10, 2),
           "simt_lse": (run("simt_lse", with_lse), 10, 2),
           "plain": (run("plain", flash_ref), 3, 1),
           "library": (sdpa, 5, 1)}
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    nbytes = 4 * (2 * BH * S * dh + 2 * BHkv * S * dh)
    flops = 2 * BH * S * S * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    err = float((out["flash_attention_simt"] - out["plain"]).abs().max())
    if err > FLASH_TOL["float32"]:
        raise AssertionError(f"timed float32 flash_attention_simt != plain "
                             f"({err})")
    if not torch.equal(out["simt_lse"], out["flash_attention_simt"]):
        raise AssertionError("flash_attention_simt saving lse gave another "
                             "output")
    return {"case": f"BH={BH} BHkv={BHkv} S={S} dh={dh} float32 causal",
            "ms": ms["flash_attention_simt"],
            "ms_turns": turns["flash_attention_simt"],
            "ms_with_lse": ms["simt_lse"],
            "ms_with_lse_turns": turns["simt_lse"],
            "plain_ms": ms["plain"], "plain_ms_turns": turns["plain"],
            "library_ms": ms["library"],
            "library_ms_turns": turns["library"],
            "library": "scaled_dot_product_attention(is_causal, enable_gqa) "
                       "in float32",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_3xtf32_ms": max(t_bytes,
                                   3 * flops / TF32_FLOPS_PER_S * 1e3),
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "tflops_per_s": flops / ms["flash_attention_simt"] * 1e-9}


def time_flash_bwd(torch, fa, flash_bwd_ref, dtype: str, heads=(16, 8)):
    """The backward flash kernels at the qwen3-0.6b training shape (causal,
    GQA G=2) in ``dtype``, timed in one call in turns with the plain
    version and the backward of SDPA on the same inputs (kernels, plain,
    SDPA, then the same in reverse). In bf16: ``flash_attention_bwd_sm90``
    with the lse the forward saves (its plain version
    ``flash_bwd_ref(lse=)``) and ``flash_attention_bwd`` computing lse
    itself (``flash_bwd_ref``). In float32: ``flash_attention_bwd`` given
    the lse ``flash_attention_simt`` saves, as training runs it, and
    computing it itself (``ms_without_lse``), against
    ``flash_bwd_ref(lse=)``. Bound: the gradient's five products, 2.5x the
    forward's causal products, at the card's rate for ``dtype`` (tensor
    cores for bf16, the CUDA cores for float32; for float32 also three
    TF32 products each at the TF32 rate, ``bound_3xtf32_ms``), against
    each input read and each output written once (lse's bytes too, for
    the kernel that reads it). ``heads``: the query and KV heads a row
    (qwen3-0.6b's 16 and 8; a model shard's 4 and 2 over TP_SHARDS).
    Returns {kernel name: its row}."""
    import torch.nn.functional as F
    BH, BHkv, S, dh = TRAIN_B * heads[0], TRAIN_B * heads[1], TRAIN_S, 128
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, dtype, 97)
    do = flash_inputs(torch, BH, BHkv, S, dh, dtype, 96)[0]
    sm90 = dtype == "bfloat16"
    forward = fa.flash_attention_sm90 if sm90 else fa.flash_attention_simt
    o, lse = forward(q, k, v, return_lse=True)
    B = TRAIN_B
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh).detach()
                  .requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        enable_gqa=True)
    do4 = do.view(B, BH // B, S, dh)
    out = {}

    def bwd():
        out["bwd"] = fa.flash_attention_bwd(q, k, v, o, do)

    def bwd_lse():
        out["bwd_lse"] = fa.flash_attention_bwd(q, k, v, o, do, lse=lse)

    def bwd_sm90():
        out["bwd_sm90"] = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse)

    def plain():
        out["plain"] = flash_bwd_ref(q, k, v, o, do)

    def plain_lse():
        out["plain_lse"] = flash_bwd_ref(q, k, v, o, do, lse=lse)

    def sdpa_bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    # (row, its timed call, the plain call it is held to, the lse bytes it
    # reads, the same kernel without lse)
    if sm90:
        fns = {"bwd_sm90": (bwd_sm90, 20, 3), "bwd": (bwd, 10, 2),
               "plain": (plain, 3, 1), "library": (sdpa_bwd, 10, 2),
               "plain_lse": (plain_lse, 3, 1)}
        rows = (("flash_attention_bwd_sm90", "bwd_sm90", "plain_lse",
                 4 * BH * S, None),
                ("flash_attention_bwd", "bwd", "plain", 0, None))
    else:
        fns = {"bwd_lse": (bwd_lse, 10, 2), "bwd": (bwd, 10, 2),
               "plain_lse": (plain_lse, 3, 1), "library": (sdpa_bwd, 10, 2)}
        rows = (("flash_attention_bwd", "bwd_lse", "plain_lse", 4 * BH * S,
                 "bwd"),)
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    elt = 2 if dtype == "bfloat16" else 4
    # reads of q, o, dO and k, v; writes of dq and dk, dv
    nbytes = elt * (4 * BH + 4 * BHkv) * S * dh
    flops = 5 * BH * S * S * dh      # 2.5 x the forward's 2 BH S^2 dh
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else FP32_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    res = {}
    for name, key, plain_key, extra, alone in rows:
        checked = [key] if alone is None else [key, alone]
        errs = [(float((a.float() - b.float()).abs().max()),
                 float(b.float().abs().max()))
                for c in checked for a, b in zip(out[c], out[plain_key])]
        err = max(e for e, _ in errs)
        rel = max(e / m for e, m in errs)
        if rel > FLASH_TOL[dtype]:
            raise AssertionError(f"timed {name} ({dtype}) != plain ({rel} "
                                 "of an output's max)")
        t_bytes = (nbytes + extra) / HBM_BYTES_PER_S * 1e3
        res[name] = {
            "case": f"BH={BH} BHkv={BHkv} S={S} dh={dh} {dtype} causal",
            "ms": ms[key], "ms_turns": turns[key],
            "plain_ms": ms[plain_key], "plain_ms_turns": turns[plain_key],
            "library_ms": ms["library"],
            "library_ms_turns": turns["library"],
            "library": "backward of scaled_dot_product_attention(is_causal, "
                       f"enable_gqa) in {dtype}",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes + extra, "flops": flops, "max_abs_err": err,
            "err_over_max": rel,
            "tflops_per_s": flops / ms[key] * 1e-9}
        if alone is not None:
            res[name].update(ms_without_lse=ms[alone],
                             ms_without_lse_turns=turns[alone])
        if dtype == "float32":
            res[name]["bound_3xtf32_ms"] = max(
                t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3)
    return res


def _time_flash_bwd_case(torch, fa, flash_bwd_ref, BH, BHkv, S, dh, causal,
                         seed, earlier=False):
    """The backward kernel that ``FlashAttention`` runs for bf16 at
    ``dh`` (``flash_attention_bwd_sm90`` after ``flash_attention_sm90``,
    else ``flash_attention_bwd`` after ``flash_attention_simt``), given
    the lse its forward saves, at (BH, BHkv, S, dh, causal), timed in one
    call in turns with its plain version ``flash_bwd_ref(lse=)`` and the
    backward of SDPA on the same inputs (kernel, plain, SDPA, then in
    reverse): CUDA-event ms, and the bound at the bf16 tensor-core rate
    (the gradient's products: 2.5x the forward's 2 BH S^2 dh
    multiply-adds, halved when causal) against each input read and each
    output written once, lse's bytes too. With ``earlier``, also
    ``flash_attention_bwd`` (the 3xTF32 kernel that ran the shape before)
    given ``flash_attention_simt``'s lse, called directly in the same
    turns and held to ``flash_bwd_ref`` with that lse
    (``earlier_ms``)."""
    import torch.nn.functional as F
    fwd = fa.route(torch.bfloat16, dh)
    kernel = ("flash_attention_bwd_sm90" if fwd == "flash_attention_sm90"
              else "flash_attention_bwd")
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, "bfloat16", seed)
    do = flash_inputs(torch, BH, BHkv, S, dh, "bfloat16", seed + 1)[0]
    o, lse = getattr(fa, fwd)(q, k, v, causal, return_lse=True)
    B = TRAIN_B
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh).detach()
                  .requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                        enable_gqa=BH != BHkv)
    do4 = do.view(B, BH // B, S, dh)
    out = {}

    def run():
        if kernel == "flash_attention_bwd_sm90":
            out["kernel"] = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse,
                                                        causal)
        else:
            out["kernel"] = fa.flash_attention_bwd(q, k, v, o, do, causal,
                                                   lse=lse)

    def plain():
        out["plain"] = flash_bwd_ref(q, k, v, o, do, causal, lse=lse)

    def sdpa_bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    fast = kernel == "flash_attention_bwd_sm90"
    fns = {"kernel": (run, 20 if fast else 5, 3 if fast else 1),
           "plain": (plain, 3, 1), "library": (sdpa_bwd, 10, 2)}
    if earlier:
        o_old, lse_old = fa.flash_attention_simt(q, k, v, causal,
                                                 return_lse=True)
        out["plain_earlier"] = flash_bwd_ref(q, k, v, o_old, do, causal,
                                             lse=lse_old)

        def run_earlier():
            out["earlier"] = fa.flash_attention_bwd(q, k, v, o_old, do,
                                                    causal, lse=lse_old)
        fns["earlier"] = (run_earlier, 5, 1)
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    tag = (f"BH={BH} BHkv={BHkv} S={S} dh={dh} bf16 "
           f"{'causal' if causal else 'not causal'}")

    def held(key, plain_key, who):
        errs = [(float((a.float() - b.float()).abs().max()),
                 float(b.float().abs().max()))
                for a, b in zip(out[key], out[plain_key])]
        rel = max(e / m for e, m in errs)
        if rel > FLASH_TOL["bfloat16"]:
            raise AssertionError(f"timed {who} at {tag} != plain ({rel} of "
                                 "an output's max)")
        return errs, rel

    errs, rel = held("kernel", "plain", kernel)
    nbytes = 2 * (4 * BH + 4 * BHkv) * S * dh + 4 * BH * S
    flops = (5 if causal else 10) * BH * S * S * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    row = {"case": tag, "kernel": kernel, "forward": fwd,
           "ms": ms["kernel"], "ms_turns": turns["kernel"],
           "plain_ms": ms["plain"], "plain_ms_turns": turns["plain"],
           "library_ms": ms["library"], "library_ms_turns": turns["library"],
           "library": "backward of scaled_dot_product_attention(is_causal="
           f"{causal}{', enable_gqa' if BH != BHkv else ''}) in bfloat16",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops,
           "max_abs_err": max(e for e, _ in errs), "err_over_max": rel,
           "tflops_per_s": flops / ms["kernel"] * 1e-9}
    if earlier:
        old, old_rel = held("earlier", "plain_earlier", "flash_attention_bwd")
        row.update(earlier_kernel="flash_attention_bwd",
                   earlier_ms=ms["earlier"], earlier_ms_turns=turns["earlier"],
                   earlier_max_abs_err=max(e for e, _ in old),
                   earlier_err_over_max=old_rel,
                   earlier_tflops_per_s=flops / ms["earlier"] * 1e-9)
    return row


def time_flash_bwd_stacks(torch, fa, flash_bwd_ref):
    """The backward kernels at the new training paths' shapes, by
    ``_time_flash_bwd_case``: ``flash_attention_bwd_sm90`` not causal at
    whisper-medium's encoder (BH = BHkv = 64, S = 1500, dh = 64;
    ``lm_train_encdec``) and at zamba2-7b's shared attention (BH = BHkv =
    128, S = 2048, dh = 112 on zero columns up to 128, causal;
    ``lm_train_ssm``), there beside ``flash_attention_bwd``, the 3xTF32
    kernel that ran it before."""
    return {"whisper_encoder": _time_flash_bwd_case(
                torch, fa, flash_bwd_ref, TRAIN_B * 16, TRAIN_B * 16, 1500,
                64, False, 93),
            "zamba2": _time_flash_bwd_case(
                torch, fa, flash_bwd_ref, TRAIN_B * 32, TRAIN_B * 32,
                TRAIN_S, 112, True, 91, earlier=True)}


def cuda_ms(torch, fn, n: int, warm: int = 3) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``n`` calls
    after ``warm`` warm-up calls."""
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def device_ms(torch, kv, fn, n: int, name: str, tries: int = 3) -> float:
    """Milliseconds of device time per launch of the CUDA kernel ``name``
    (a key of ``kv.COUNTS``; its entry function is ``<name>_kernel``) over
    ``n`` calls of ``fn`` under ``torch.profiler``, after one warm-up
    call. Unlike CUDA events around the calls, this leaves out the host's
    time between launches, which exceeds a short kernel's. The calls must
    launch the kernel ``n`` times by the wrapper's count. On the card the
    profiler now and then drops launches from its trace (one of 50, or
    all of 20): the time is the mean over the launches the trace holds,
    and a trace that holds fewer than half is taken again, up to
    ``tries`` times; then it raises."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    kernel = f"{name}_kernel"
    for _ in range(tries):
        before = kv.COUNTS[name]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        if kv.COUNTS[name] - before != n:
            raise AssertionError(f"{n} calls launched {name} "
                                 f"{kv.COUNTS[name] - before} times")
        us, calls, seen = 0.0, 0, []
        for e in prof.key_averages():
            if e.device_type == cuda:
                seen.append(e.key[:60])
            if e.device_type == cuda and kernel in e.key:
                us += float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0.0)))
                calls += e.count
        if 2 * calls >= n and us > 0:
            return us / 1e3 / calls
    raise AssertionError(f"profiler saw {calls} of {n} launches of {kernel} "
                         f"with {us} us; device events: {seen[:8]}")


def bound(nbytes: int, ops: int) -> dict:
    """The least time for the work: bytes over the memory rate against
    instructions over the INT32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "int_ops": ops}


def table_words(rows, row_words: int, ctab: bool) -> int:
    """Words of the code tables a Vcycle kernel must read (``RowTables``):
    the ``row_words`` of each row that it reads (of a row's eight: the
    first four, and the capture index where it captures SEND values), the
    per-core table where it is handed one (``ctab``), and the distinct LUT
    truth tables. The chunk kernel's rows are each core's live rows only,
    so NOP slots it never reads are not charged."""
    return (row_words * rows.n_rows + (rows.ctab.numel() if ctab else 0)
            + 16 * rows.n_tts)


def row_fields(ms: float, vcycles: int, rows, code_bytes: int) -> dict:
    """What bounds a Vcycle kernel: the busiest core's rows a Vcycle, the
    kernel's ns per such row (ms over Vcycles x busy rows), and the bytes
    of code rows it reads from device memory a launch."""
    return {"busy_rows": rows.busy, "live_rows": rows.n_rows,
            "ns_per_busy_row": ms * 1e6 / max(vcycles * rows.busy, 1),
            "code_bytes": code_bytes}


def time_chunk(torch, kv, k, st, cyc, tag):
    """One chunk of binding ``k`` on state ``st`` ([B, ...] leaves): the
    kernel's device time (``device_ms``, 20 launches) and the time of a
    wrapper call (CUDA events, 20 calls after 3 warm-ups), the plain
    version once on the same inputs, the bound, what bounds the kernel
    (``row_fields``) and its occupancy (blocks an SM holds, waves)."""
    glob = {}
    if k.gcore >= 0:
        glob = dict(gmem=st.gmem, tags=st.cache_tags, counters=st.counters,
                    cache=k.cache)
    args = (*k.tables(), st.regs, st.spads, st.flags, cyc)
    kw = dict(K=k.K, n_sends=k.n_sends, num_pro=k.num_pro, **glob)
    budget = 10**6
    out = [None]

    def launch():
        out[-1] = kv.vcycle_chunk(*args, budget, layout=k.layout,
                                  gcore=k.gcore, rows=k.rows, **kw)

    event_ms = cuda_ms(torch, launch, 20)
    ms = device_ms(torch, kv, launch, 20, "vcycle_chunk")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ref = kv.vcycle_chunk_ref(*args, budget, **kw)
    t1.record()
    torch.cuda.synchronize()
    err = max(_same(a, b) for a, b in zip(out[-1], ref))
    if err:
        raise AssertionError(f"timed chunk {tag}: kernel != plain ({err})")
    nexec = out[-1][3].long()
    T = k.code.shape[0]
    B, C, R = st.regs.shape
    S = st.spads.shape[2]
    M = k.dcore.shape[0]
    state = B * C * R + B * C * S + B * C
    extra = {}
    if glob:
        state += st.gmem.numel() + st.cache_tags.numel() + B * 4
        # the wrapper copies the global state for the kernel to update in
        # place; that copy is part of ``ms``
        extra["copy_ms"] = cuda_ms(torch, lambda: tuple(
            t.clone() for t in (st.gmem, st.cache_tags, st.counters)), 20)
    # the code tables it reads (a row's first 16 bytes and its capture
    # index, the per-core table), the exchange, the register offsets, the
    # state in and out, cyc and nexec; one instruction per live row run
    nbytes = 4 * (table_words(k.rows, 5, True) + 2 * M + C + 1 + 2 * state
                  + 2 * B)
    n_run = int(nexec.sum())
    smem, per_sm, staged = kv.chunk_occupancy(C, k.rows, k.layout.words, S,
                                              k.n_sends, bool(glob))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # staged: each block copies every row's first 16 bytes and capture
    # index once; else each row run is a 32-byte read
    code_bytes = (20 * B * k.rows.n_rows if staged
                  else 32 * n_run * k.rows.n_rows)
    return {"case": tag, "ms": ms, "event_ms": event_ms,
            "plain_ms": t0.elapsed_time(t1), **extra,
            **bound(nbytes, n_run * k.rows.n_rows), "max_abs_err": err,
            **row_fields(ms, int(nexec.max()), k.rows, code_bytes),
            "rows_staged": staged, "smem_bytes_per_block": smem,
            "blocks_per_sm": per_sm,
            "waves": -(-B // (sms * per_sm)) if per_sm else None,
            "shape": {"B": B, "C": C, "T": T, "R": R, "S": S, "K": k.K,
                      "G": int(st.gmem.shape[-1]) if glob else 0},
            "vcycles_per_chunk": nexec.tolist()[:1]}


def phase_timing(torch, kv, bsp, eng, s_mc, bat_fig8):
    """Each kernel at the shapes its paths give it: the chunk kernel at the
    main path's (mc/full, B=512), at B=1 (mc/full) and at Fig 8's
    ram/512 KiB with B=64; the seed kernel at mc/full."""
    m = eng.m
    chunk = {"main": time_chunk(
        torch, kv, m._kernel, m.init_state(),
        torch.zeros((m.B,), dtype=torch.int32, device=m.device),
        f"mc/full B={m.B}")}
    m1 = bsp.Machine(s_mc.program)
    st1 = bsp.MachineState(*(x[None] for x in m1.init_state()))
    chunk["b1"] = time_chunk(torch, kv, m1._kernel, st1,
                             torch.zeros((1,), dtype=torch.int32,
                                         device=m1.device), "mc/full B=1")
    mb = bat_fig8.m
    chunk["fig8"] = time_chunk(torch, kv, mb._kernel, mb.init_state(),
                               torch.zeros((mb.B,), dtype=torch.int32,
                                           device=mb.device),
                               f"fig8 ram/512KiB B={mb.B}")
    # the seed kernel: one Vcycle of mc/full from its initial state
    ms_ = bsp.Machine(s_mc.program, specialize=False)
    b = ms_._seed
    regs, spads, gmem, flags, tags, counters = ms_.init_state()
    args = (b.code, b.luts, regs, spads, flags)
    out = [None]

    def launch():
        out[-1] = kv.vcycle_seed(*args, gcore=b.gcore, tables=b.tables)

    event_ms = cuda_ms(torch, launch, 50)
    ms = device_ms(torch, kv, launch, 50, "vcycle_seed")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ref = kv.vcycle_seed_ref(*args)
    t1.record()
    torch.cuda.synchronize()
    err = max(_same(a, c) for a, c in zip(out[-1], ref))
    if err:
        raise AssertionError(f"timed seed Vcycle: kernel != plain ({err})")
    T = b.code.shape[0]
    C, R = regs.shape
    S = spads.shape[1]
    # the code tables it reads (a row's first 16 bytes: seed rows capture
    # nothing, and it is handed no per-core table), the register offsets,
    # the state in and out, the trace
    rows = b.tables.rows
    nbytes = 4 * (table_words(rows, 4, False) + C + 1
                  + 2 * (C * R + C * S + C) + T * C)
    seed = {"case": "mc/full", "ms": ms, "event_ms": event_ms,
            "plain_ms": t0.elapsed_time(t1),
            **bound(nbytes, T * C), "max_abs_err": err,
            # each warp copies its core's T rows' first 16 bytes once
            # (mc's T=137 rows fit: the kernel stages them)
            **row_fields(ms, 1, rows, 16 * C * T),
            "shape": {"C": C, "T": T, "R": R, "S": S}}
    return chunk, seed


SHAPE_KEYS = ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "row_rel_err", "earlier_kernel", "earlier_ms",
              "plain_heads")


def shape_row(launches, t) -> dict:
    """A kernel's row at another shape of the ``kernels`` line: its
    launches there and the timing's SHAPE_KEYS it has (``earlier_ms``:
    the kernel that ran the shape before, timed in the same turns)."""
    return {"launches": launches, **{k: t[k] for k in SHAPE_KEYS if k in t}}


def kernel_line(name, source, replaces, launches, t, by_path=None):
    """One kernel's entry of the ``kernels`` line; ``launches`` counts the
    main path, ``by_path`` (where given) every path that launches it."""
    line = {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}
    for key in ("bound_3xtf32_ms", "ms_with_lse", "ms_without_lse"):
        if key in t:
            line[key] = t[key]
    if by_path is not None:
        line["launches_by_path"] = by_path
    return line


# The LM phases in the order ``main`` runs them, and what each reads of
# another's results: ``lm_serve_tp`` is held to ``lm_serve_moe``'s logits
# and routes, ``lm_serve_seq`` to ``lm_serve``'s logits.
LM_PHASES = ("lm_serve", "lm_serve_moe", "lm_serve_ssm", "lm_serve_encdec",
             "lm_serve_vlm", "lm_train", "lm_train_encdec", "lm_train_ssm",
             "lm_configs", "lm_train_dp", "lm_serve_dp", "lm_train_tp",
             "lm_serve_tp", "lm_tp_stacks", "lm_serve_seq", "lm_serve_big",
             "dryrun")
LM_NEEDS = {"lm_serve_tp": ("lm_serve_moe",), "lm_serve_seq": ("lm_serve",)}


def lm_phases(m: dict) -> dict:
    """Each LM phase as a call of no arguments, over ``main``'s modules
    and device line ``m`` (its ``locals()``); the phases that keep
    results for a later one share ``keep``."""
    torch, fa, kv, steps, L, ARCHS = (m[k] for k in (
        "torch", "fa", "kv", "steps", "L", "ARCHS"))
    flash_ref, adamw, SH, TP, MOE = (m[k] for k in (
        "flash_ref", "adamw", "SH", "TP", "MOE"))
    TokenPipeline, PipelineConfig, mesh = (m[k] for k in (
        "TokenPipeline", "PipelineConfig", "make_host_mesh"))
    smi, profile_serve = m["smi"], m["profile_serve"]
    keep = {"lm": [], "moe": [], "routes": []}

    def serve_tp():
        out = phase_lm_serve_tp(torch, fa, kv, steps, ARCHS, SH, mesh,
                                keep["moe"][0], MOE, keep["routes"])
        keep["routes"].clear()
        return out

    return {
        "lm_serve": lambda: phase_lm_serve(
            torch, fa, kv, flash_ref, steps, L, ARCHS, keep=keep["lm"]),
        "lm_serve_moe": lambda: phase_lm_serve_moe(
            torch, fa, kv, flash_ref, steps, L, MOE, ARCHS,
            keep=keep["moe"], routes=keep["routes"]),
        "lm_serve_ssm": lambda: phase_lm_serve_ssm(
            torch, fa, kv, flash_ref, steps, L, ARCHS, smi),
        "lm_serve_encdec": lambda: phase_lm_serve_encdec(
            torch, fa, kv, flash_ref, steps, L, ARCHS, smi, profile_serve),
        "lm_serve_vlm": lambda: phase_lm_serve_vlm(
            torch, fa, kv, flash_ref, steps, L, ARCHS, smi, profile_serve),
        "lm_train": lambda: phase_lm_train(
            torch, fa, kv, flash_ref, steps, L, ARCHS, adamw, TokenPipeline,
            PipelineConfig, m["CheckpointManager"]),
        "lm_train_encdec": lambda: phase_lm_train_encdec(
            torch, fa, kv, flash_ref, steps, L, ARCHS, adamw, TokenPipeline,
            PipelineConfig, smi, profile_serve),
        "lm_train_ssm": lambda: phase_lm_train_ssm(
            torch, fa, kv, flash_ref, steps, L, ARCHS, adamw, TokenPipeline,
            PipelineConfig, smi),
        "lm_configs": lambda: phase_lm_configs(
            torch, fa, kv, flash_ref, steps, L, ARCHS, adamw, TokenPipeline,
            PipelineConfig, smi),
        "lm_train_dp": lambda: phase_lm_train_dp(
            torch, fa, kv, steps, ARCHS, adamw, TokenPipeline,
            PipelineConfig, SH, m["OV"], mesh),
        "lm_serve_dp": lambda: phase_lm_serve_dp(
            torch, fa, kv, steps, ARCHS, SH, mesh),
        "lm_train_tp": lambda: phase_lm_train_tp(
            torch, fa, kv, steps, ARCHS, adamw, TokenPipeline,
            PipelineConfig, SH, TP, mesh),
        "lm_serve_tp": serve_tp,
        "lm_tp_stacks": lambda: phase_lm_tp_stacks(
            torch, fa, kv, steps, ARCHS, adamw, TokenPipeline,
            PipelineConfig, SH, TP, mesh, smi, profile_serve),
        "lm_serve_seq": lambda: phase_lm_serve_seq(
            torch, fa, kv, steps, ARCHS, SH, TP, mesh, keep["lm"][0]),
        "lm_serve_big": lambda: phase_lm_serve_big(
            torch, fa, kv, steps, ARCHS, SH, mesh, profile_serve, smi),
        "dryrun": lambda: phase_dryrun(
            torch, fa, kv, flash_ref, steps, ARCHS, adamw, smi),
    }


def run_lm_phases(table: dict, names) -> dict:
    """Runs the phases of ``table`` named in ``names`` and those they need
    (``LM_NEEDS``), in ``LM_PHASES``' order; returns each one's result."""
    want = set(names)
    for name in names:
        if name not in table:
            raise ValueError(f"no LM phase {name!r}; the phases: "
                             f"{', '.join(LM_PHASES)}")
        want.update(LM_NEEDS.get(name, ()))
    return {name: table[name]() for name in LM_PHASES if name in want}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--phases", default="",
                    help="comma-separated LM phases to run alone (and those "
                         "they need), after the kernels' build: "
                         + ", ".join(LM_PHASES))
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import repro_torch.serve as serve
        import repro_torch.sim as sim
        from repro_torch.circuits import FINISH
        from repro_torch.circuits.fig8 import build_membench
        from repro_torch.configs import ARCHS
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
        from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
        from repro_torch.launch import profile_serve, steps
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.distributed import overlap as OV
        from repro_torch.distributed import sharding as SH
        from repro_torch.distributed import tensor_parallel as TP
        from repro_torch.optim import adamw
        from repro_torch.runtime.checkpoint import CheckpointManager
        from repro_torch.models import layers as L
        from repro_torch.models import moe as MOE
        from repro_torch.runtime import elastic
        from repro_torch.core import bsp
        from repro_torch.core.grid import GridMachine
        from repro_torch.core.isa import HardwareConfig
        from repro_torch.core.isasim import IsaSim
        from repro_torch.kernels import vcycle as kv
        from repro_torch.kernels.randprog import random_chunk, random_vcycle
        from repro_torch.kernels.ref import CacheModel
        from repro_torch.sim.engine import IsaEngine
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if phases:
        smi = phase_device(torch)
        emit({"phase": "build", "build_s": timed_build(kbuild)[2]})
        lm = run_lm_phases(lm_phases(locals()), phases)
        emit({"phase": "done", "phases": list(lm),
              "seconds": time.perf_counter() - t_start})
        print(smi)
        print(json.dumps({"ok": True, "phases": list(lm), "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    workers = max(1, min(len(NAMES), (os.cpu_count() or 2) - 1))
    with cf.ThreadPoolExecutor(1) as nvcc, cf.ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn")) as pool:
        build_future = nvcc.submit(timed_build, kbuild)
        compiles = [pool.submit(compile_full, n, CHECK_SEEDS) for n in NAMES]
        smi = phase_device(torch)
        phase_build(kbuild, build_future)
        phase_flash(torch, fa, flash_ref, kbuild)
        phase_flash_bwd(torch, fa, flash_bwd_ref, flash_ref)
        phase_random(torch, kv, random_chunk, CacheModel)
        phase_seed_random(torch, kv, random_vcycle, CacheModel)
        for fut in cf.as_completed(compiles):
            item = fut.result()
            phase_circuit(torch, kv, bsp, IsaSim, item)
            check_seed_circuit(torch, kv, bsp, item)
    # this slice's path: the seed arm on all nine full circuits
    seed_launches = b1_launches = 0
    for name in NAMES:
        s, n_seed, n_b1 = phase_seed_arm(torch, kv, sim, name)
        seed_launches += n_seed
        b1_launches += n_b1
        if name == "mc":
            s_mc = s
    fig8_hw = HardwareConfig(grid_width=1, grid_height=1,
                             spad_words=1 << 14, num_regs=4096,
                             imem_slots=1 << 16)
    bat_fig8 = phase_fig8(torch, kv, sim, bsp, IsaEngine, build_membench,
                          fig8_hw, CacheModel)
    eng, launches, s_main, results = phase_main(torch, kv, sim, IsaEngine)
    serve_launches = phase_serve(torch, kv, sim, serve, IsaEngine)
    elastic_launches = phase_elastic(torch, kv, sim, elastic,
                                     HardwareConfig, FINISH)
    sharded_launches, s_bc = phase_sharded(torch, kv, sim, bsp, IsaEngine,
                                           FINISH, s_main, results)
    grid_launches = phase_grid(torch, kv, bsp, GridMachine, FINISH,
                               (("mc", s_main), ("bc", s_bc)))
    lm = run_lm_phases(lm_phases(locals()), LM_PHASES)
    sm90_launches, simt_launches = lm["lm_serve"]
    moe_sm90_launches, moe_simt_launches, mixtral_launches = \
        lm["lm_serve_moe"]
    ssm_sm90_launches, ssm_fp32_launches = lm["lm_serve_ssm"]
    encdec_sm90_launches, encdec_fp32_launches = lm["lm_serve_encdec"]
    vlm_sm90_launches, vlm_fp32_launches = lm["lm_serve_vlm"]
    train_launches, fp32_train_launches = lm["lm_train"]
    encdec_train_launches, fp32_encdec_train_launches = \
        lm["lm_train_encdec"]
    ssm_train_launches, fp32_ssm_train_launches = lm["lm_train_ssm"]
    dp_launches, fp32_dp_launches = lm["lm_train_dp"]
    serve_dp_launches, serve_dp_fp32_launches = lm["lm_serve_dp"]
    tp_launches, fp32_tp_launches = lm["lm_train_tp"]
    serve_tp_launches, serve_tp_fp32_launches = lm["lm_serve_tp"]
    stacks_launches, stacks_fp32_launches = lm["lm_tp_stacks"]
    seq_launches, seq_fp32_launches = lm["lm_serve_seq"]
    configs_launches, configs_fp32_launches, by_config = lm["lm_configs"]
    starcoder2 = by_config["starcoder2-3b"]
    big_launches, big_fp32_launches = lm["lm_serve_big"]
    dry_launches = lm["dryrun"]
    chunk, seed = phase_timing(torch, kv, bsp, eng, s_mc, bat_fig8)
    flash = time_flash(torch, fa, flash_ref)
    flash32 = time_flash_fp32(torch, fa, flash_ref)
    flash112 = time_flash_zamba2(torch, fa, flash_ref)
    flash_encdec = time_flash_encdec(torch, fa, flash_ref)
    bwd = {dt: time_flash_bwd(torch, fa, flash_bwd_ref, dt)
           for dt in ("bfloat16", "float32")}
    # a model shard's heads in lm_train_tp: 4 query and 2 KV heads a row
    flash_tp = _time_flash_case(torch, fa, flash_ref, TRAIN_B * 4,
                                TRAIN_B * 2, TRAIN_S, 128, True, 95)
    bwd_tp = time_flash_bwd(torch, fa, flash_bwd_ref, "bfloat16", (4, 2))[
        "flash_attention_bwd_sm90"]
    bwd_stacks = time_flash_bwd_stacks(torch, fa, flash_bwd_ref)
    # starcoder2-3b's prefill and training shapes (24 query heads over 2
    # KV heads: G 12), and a qwen1.5-110b model shard's prefill (16 over 2)
    flash_g12 = _time_flash_case(torch, fa, flash_ref, LM_BATCH * 24,
                                 LM_BATCH * 2, LM_PROMPT, 128, True, 98)
    bwd_g12 = time_flash_bwd(torch, fa, flash_bwd_ref, "bfloat16", (24, 2))[
        "flash_attention_bwd_sm90"]
    flash_big = _time_flash_case(torch, fa, flash_ref, LM_BATCH * 16,
                                 LM_BATCH * 2, LM_PROMPT, 128, True, 99)
    # the dry run's prefill of qwen3-0.6b (16 query and 8 KV heads a row),
    # the plain version on two heads
    flash_s32768 = _time_flash_case(torch, fa, flash_ref, DRY_PREFILL_B * 16,
                                    DRY_PREFILL_B * 8, DRY_PREFILL_S, 128,
                                    True, 96, plain_heads=2)
    emit({"phase": "timing", "vcycle_chunk": chunk, "vcycle_seed": seed,
          **flash, "flash_attention_simt_fp32": flash32,
          "flash_attention_sm90_zamba2": flash112,
          "flash_attention_sm90_encdec": flash_encdec,
          "flash_attention_bwd_sm90": bwd["bfloat16"][
              "flash_attention_bwd_sm90"],
          "flash_attention_bwd": bwd["bfloat16"]["flash_attention_bwd"],
          "flash_attention_bwd_fp32": bwd["float32"]["flash_attention_bwd"],
          "flash_attention_sm90_tp_shard": flash_tp,
          "flash_attention_bwd_sm90_tp_shard": bwd_tp,
          "flash_attention_bwd_sm90_whisper_encoder":
          bwd_stacks["whisper_encoder"],
          "flash_attention_bwd_sm90_zamba2": bwd_stacks["zamba2"],
          "flash_attention_sm90_starcoder2_g12": flash_g12,
          "flash_attention_bwd_sm90_starcoder2_g12": bwd_g12,
          "flash_attention_sm90_big_shard": flash_big,
          "flash_attention_sm90_dryrun_prefill": flash_s32768,
          "launches_on_bf16_configs_paths": configs_launches,
          "launches_on_fp32_configs_checks": configs_fp32_launches,
          "sm90_launches_on_bf16_big_serving_path": big_launches,
          "simt_launches_on_fp32_big_serving_check": big_fp32_launches,
          "sm90_launches_on_bf16_mixtral_serving_path": mixtral_launches,
          "launches_on_bf16_encdec_train_path": encdec_train_launches,
          "launches_on_fp32_encdec_train_check": fp32_encdec_train_launches,
          "launches_on_bf16_ssm_train_path": ssm_train_launches,
          "launches_on_fp32_ssm_train_check": fp32_ssm_train_launches,
          "launches_on_bf16_tp_train_path": tp_launches,
          "launches_on_fp32_tp_train_check": fp32_tp_launches,
          "sm90_launches_on_bf16_tp_serving_path": serve_tp_launches,
          "simt_launches_on_fp32_tp_serving_check": serve_tp_fp32_launches,
          "launches_on_bf16_tp_stacks_path": stacks_launches,
          "launches_on_fp32_tp_stacks_checks": stacks_fp32_launches,
          "sm90_launches_on_bf16_seq_serving_path": seq_launches,
          "simt_launches_on_fp32_seq_serving_check": seq_fp32_launches,
          "launches_on_fp32_train_check": fp32_train_launches,
          "launches_on_bf16_train_path": train_launches,
          "launches_on_bf16_dp_train_path": dp_launches,
          "launches_on_fp32_dp_train_check": fp32_dp_launches,
          "sm90_launches_on_bf16_dp_serving_path": serve_dp_launches,
          "simt_launches_on_fp32_dp_serving_check": serve_dp_fp32_launches,
          "seed_launches_on_seed_path": seed_launches,
          "b1_chunk_launches_on_machine_path": b1_launches,
          "sm90_launches_on_bf16_serving_path": sm90_launches,
          "simt_launches_on_fp32_serving_path": simt_launches,
          "sm90_launches_on_bf16_moe_serving_path": moe_sm90_launches,
          "simt_launches_on_fp32_moe_serving_check": moe_simt_launches,
          "sm90_launches_on_bf16_ssm_serving_path": ssm_sm90_launches,
          "simt_launches_on_fp32_ssm_serving_check": ssm_fp32_launches,
          "sm90_launches_on_bf16_encdec_serving_path": encdec_sm90_launches,
          "simt_launches_on_fp32_encdec_serving_check": encdec_fp32_launches,
          "sm90_launches_on_bf16_vlm_serving_path": vlm_sm90_launches,
          "simt_launches_on_fp32_vlm_serving_check": vlm_fp32_launches,
          "chunk_launches_on_serve_path": serve_launches,
          "chunk_launches_on_elastic_path": elastic_launches,
          "chunk_launches_on_sharded_path": sharded_launches,
          "chunk_launches_on_grid_path": grid_launches})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    kernels = [
        kernel_line("vcycle_chunk",
                    "src/repro_torch/kernels/csrc/vcycle_chunk.cu",
                    "src/repro/kernels/vcycle.py:199 _chunk_kernel; "
                    "src/repro/kernels/vcycle.py:262 _chunk_kernel_batched",
                    launches, chunk["main"],
                    {"main": launches, "machine": b1_launches,
                     "serve": serve_launches, "elastic": elastic_launches,
                     "sharded": sharded_launches, "grid": grid_launches}),
        kernel_line("vcycle_seed",
                    "src/repro_torch/kernels/csrc/vcycle_seed.cu",
                    "src/repro/kernels/vcycle.py:45 _vcycle_kernel",
                    seed_launches, seed),
        {**kernel_line("flash_attention_sm90",
                       "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                       "src/repro/kernels/flash_attention.py:33 "
                       "_flash_kernel (bf16, dh 64 or a multiple of 8 from "
                       "72 to 128)",
                       sm90_launches, flash["flash_attention_sm90"],
                       {"lm_serve": sm90_launches,
                        "lm_serve_moe": moe_sm90_launches,
                        "lm_serve_moe_mixtral": mixtral_launches,
                        "lm_serve_ssm": ssm_sm90_launches,
                        "lm_serve_encdec": encdec_sm90_launches,
                        "lm_serve_vlm": vlm_sm90_launches,
                        "lm_train": train_launches["flash_attention_sm90"],
                        "lm_train_encdec":
                        encdec_train_launches["flash_attention_sm90"],
                        "lm_train_ssm":
                        ssm_train_launches["flash_attention_sm90"],
                        "lm_train_dp": dp_launches["flash_attention_sm90"],
                        "lm_serve_dp": serve_dp_launches,
                        "lm_train_tp": tp_launches["flash_attention_sm90"],
                        "lm_serve_tp": serve_tp_launches,
                        "lm_tp_stacks":
                        stacks_launches["flash_attention_sm90"],
                        "lm_serve_seq": seq_launches,
                        "lm_configs":
                        configs_launches["flash_attention_sm90"],
                        "lm_serve_big": big_launches,
                        "dryrun_train":
                        dry_launches["train"]["flash_attention_sm90"],
                        "dryrun_prefill":
                        dry_launches["prefill"]["flash_attention_sm90"]}),
         "other_shapes": {name: shape_row(n, row) for name, n, row in (
             ("zamba2_dh112", ssm_sm90_launches, flash112),
             ("whisper_encoder", encdec_sm90_launches // 2,
              flash_encdec["whisper_encoder"]),
             ("qwen2_vl_prefill", vlm_sm90_launches,
              flash_encdec["qwen2_vl_prefill"]),
             ("tp_shard", tp_launches["flash_attention_sm90"], flash_tp),
             ("starcoder2_g12", starcoder2["flash_attention_sm90"],
              flash_g12),
             ("big_shard", big_launches, flash_big),
             ("dryrun_prefill_s32768",
              dry_launches["prefill"]["flash_attention_sm90"],
              flash_s32768))}},
        {**kernel_line("flash_attention_simt",
                       "src/repro_torch/kernels/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:33 "
                       "_flash_kernel (float32, and bf16 at the head dims "
                       "flash_attention_sm90 does not take)",
                       simt_launches, flash32,
                       {"lm_serve_fp32_check": simt_launches,
                        "lm_train_encdec_fp32_check":
                        fp32_encdec_train_launches["flash_attention_simt"],
                        "lm_train_ssm_fp32_check":
                        fp32_ssm_train_launches["flash_attention_simt"],
                        "lm_serve_moe_fp32_check": moe_simt_launches,
                        "lm_serve_ssm_fp32_check": ssm_fp32_launches,
                        "lm_serve_encdec_fp32_check": encdec_fp32_launches,
                        "lm_serve_vlm_fp32_check": vlm_fp32_launches,
                        "lm_train_fp32_check":
                        fp32_train_launches["flash_attention_simt"],
                        "lm_train_dp_fp32_check":
                        fp32_dp_launches["flash_attention_simt"],
                        "lm_serve_dp_fp32_check": serve_dp_fp32_launches,
                        "lm_train_tp_fp32_check":
                        fp32_tp_launches["flash_attention_simt"],
                        "lm_serve_tp_fp32_check": serve_tp_fp32_launches,
                        "lm_tp_stacks_fp32_checks":
                        stacks_fp32_launches["flash_attention_simt"],
                        "lm_serve_seq_fp32_check": seq_fp32_launches,
                        "lm_configs_fp32_checks":
                        configs_fp32_launches["flash_attention_simt"],
                        "lm_serve_big_fp32_check": big_fp32_launches}),
         "case": flash32["case"]},
        {**kernel_line("flash_attention_bwd_sm90",
                   "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
                   "none: no TPU kernel is replaced; the gradient of "
                   "src/repro/kernels/flash_attention.py:33 _flash_kernel "
                   "(bf16, dh 64 or a multiple of 8 from 72 to 128), which "
                   "the reference takes by XLA's autodiff of "
                   "src/repro/models/layers.py:116 _sdpa",
                   train_launches["flash_attention_bwd_sm90"],
                   bwd["bfloat16"]["flash_attention_bwd_sm90"],
                   {"lm_train": train_launches["flash_attention_bwd_sm90"],
                    "lm_train_encdec":
                    encdec_train_launches["flash_attention_bwd_sm90"],
                    "lm_train_ssm":
                    ssm_train_launches["flash_attention_bwd_sm90"],
                    "lm_train_dp": dp_launches["flash_attention_bwd_sm90"],
                    "lm_train_tp": tp_launches["flash_attention_bwd_sm90"],
                    "lm_tp_stacks":
                    stacks_launches["flash_attention_bwd_sm90"],
                    "lm_configs":
                    configs_launches["flash_attention_bwd_sm90"],
                    "dryrun_train":
                    dry_launches["train"]["flash_attention_bwd_sm90"]}),
         "other_shapes": {name: shape_row(n, row) for name, n, row in (
             ("zamba2_train", ssm_train_launches["flash_attention_bwd_sm90"],
              bwd_stacks["zamba2"]),
             ("tp_shard", tp_launches["flash_attention_bwd_sm90"], bwd_tp),
             ("whisper_encoder",
              encdec_train_launches["flash_attention_bwd_sm90"] // 2,
              bwd_stacks["whisper_encoder"]),
             ("starcoder2_g12", starcoder2["flash_attention_bwd_sm90"],
              bwd_g12))}},
        kernel_line("flash_attention_bwd",
                    "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                    "none: no TPU kernel is replaced; the gradient of "
                    "src/repro/kernels/flash_attention.py:33 _flash_kernel "
                    "(float32, and bf16 at the head dims "
                    "flash_attention_bwd_sm90 does not take), which the "
                    "reference takes by XLA's autodiff of "
                    "src/repro/models/layers.py:116 _sdpa",
                    fp32_train_launches["flash_attention_bwd"],
                    bwd["float32"]["flash_attention_bwd"],
                    {"lm_train_fp32_check":
                     fp32_train_launches["flash_attention_bwd"],
                     "lm_train_encdec_fp32_check":
                     fp32_encdec_train_launches["flash_attention_bwd"],
                     "lm_train_ssm_fp32_check":
                     fp32_ssm_train_launches["flash_attention_bwd"],
                     "lm_train_dp_fp32_check":
                     fp32_dp_launches["flash_attention_bwd"],
                     "lm_train_tp_fp32_check":
                     fp32_tp_launches["flash_attention_bwd"],
                     "lm_tp_stacks_fp32_checks":
                     stacks_fp32_launches["flash_attention_bwd"],
                     "lm_configs_fp32_checks":
                     configs_fp32_launches["flash_attention_bwd"],
                     "lm_train_bf16": train_launches["flash_attention_bwd"]})]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
