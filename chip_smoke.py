"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  (a) card: the nvidia-smi name and power limit;
  (b) build: nvcc builds every kernel of tf_operator_tpu_torch/ops/csrc
      into build/torch_kernels/ (timed; registers and spills printed);
      then one-wgmma probes of how the tensor core reads an fp32 operand
      of a .tf32 product (ops/flash.py tf32_probe): the 3xTF32 kernels
      (the fp32 forward, dQ and dK/dV) assume that it truncates the value
      to TF32 (each lo they write) and that the register A fragment has
      their layout (ops/csrc/tf32x3.cuh), and the phase fails if either
      does not hold;
  (c) kernels against their plain versions, on the card in bf16: rope
      (forward and the inverse backward), the flash forward (o, lse), dQ
      and dK/dV (with and without a dlse cotangent), at the llama-400m
      shapes [8, 2048, 8, 128] causal and in GQA 8:2, non-causal,
      cross-length, seq-96, seq-200, GQA 8:1 seq-320 (the last three end
      inside a 128-row tile) and non-causal GQA 8:2 cross-length cases with
      both lengths ragged; each kernel's median time over CUDA events
      (rope's over replays of a CUDA graph of 20 calls, as it is shorter
      than its wrapper's host cost), its plain version's, its bound
      (ops/flash.py flash_work, ops/rope.py rope_work) and share of it
      and, for the forward, the time of torch's
      scaled_dot_product_attention as a yardstick (timed here only; the
      port never calls it), and for dQ and dK/dV together the time of its
      backward alone (a saved forward, torch.autograd.grad), beside the
      sum of the two kernels; for rope also its time by events without a
      graph, the host cost of a wrapper call, and a copy of x both ways;
      then the head_dim-64 instances of the three flash kernels
      (CASES_D64: bert-base's [16, 512, 12, 64] non-causal, causal, causal
      GQA 12:4 at seq 320 and non-causal cross-length with both lengths
      ragged), each case timed: each kernel, its plain version, its bound
      and share, and SDPA's forward and its forward and backward;
  (d) full-width parity: a 2-layer model at llama-400m width from one set
      of seeded weights, bs 1, seq 2048: loss and per-parameter gradient
      norms on the card (kernels, bf16) against the CPU (plain, fp32);
  (e) training, the main path: llama-400m at full width and depth through
      the llama_train entry point at its default remat policy "dots", 1
      warm-up step and 3 timed steps at bs 8, seq 2048 (lr warmup of 1
      step, so that the weights move from the second update on), with the
      kernels' launch counters and the peak device memory reset just
      before and read just after; launches per step must be rope 144,
      flash_fwd 24, flash_dq 24 and flash_dkv 24 (the flash forward is
      saved, not replayed); step time, tokens/s and MFU from the entry
      point's window (the host reads the loss at the first and the last
      step only, so the steps between queue ahead of the card);
  (f) remat policies: the same run under "nothing", "dots" and
      "dots+rope": step time, peak memory and launches per step of each
      (flash_fwd 48 under "nothing", rope 96 under "dots+rope"); all 4
      losses agree within 1e-3 relative, and every parameter's gradient
      of one backward on the first batch within 1e-2 relative (L2) of
      "nothing"'s;
  (g) data: a seeded uint16 token file written into a temporary directory
      (nothing is downloaded); the native loader must build and run, and
      its first batches equal the Python path's byte for byte;
      llama_train --data runs 3 steps with the device prefetch stage, and
      the same steps on the host batches without it give the same losses;
  (h) the sharded step: a one-rank NCCL group in this process, mesh
      {"fsdp": 1}, the FSDP2-sharded llama-400m born sharded through the
      entry point for 4 steps from phase e's seed; its losses agree with
      phase e's, and its gradients of one backward with phase f's "dots"
      ones, at phase f's tolerances;
  (i) checkpoint and restore, llama-400m at full width and depth under
      "dots" from phase g's seeded token file: U trains 4 steps with no
      checkpoint; A trains 2 steps with --checkpoint-dir D and saves at its
      end (the seconds save() blocked the loop, the persist seconds to the
      durability edge and the bytes written); the storage restore that B
      will make (llama_train's setup on D) lands on step 2; a shard server
      over A's manager serves that step to restore_with_fallback into a
      blanked state, once over the bundle wire ("peer") and once by
      scatter-gather ("peer-sharded"), each byte-equal to the storage
      restore (seconds and bytes of every rung); B, --steps 4 on D, resumes
      from step 2 via storage and its 2 losses equal U's steps 2-3 (phase
      f's tolerance) at phase e's launches per step; last, the torn-snapshot
      check: a save at step 1 with its persist held, one more step enqueued
      at once (AdamW updates in place), then the persisted bytes must equal
      the state at the save (the device time of the snapshot's copies,
      CUDA events);
  (j) the flagship as a pod runs it: ``python -m tf_operator_tpu_torch.
      train.llama_train`` as a subprocess, llama-400m at full width and
      depth from phase g's seeded token file, 32 steps, a checkpoint every
      3, under a one-replica JAXJob pod's env (JAX_NUM_PROCESSES=1,
      JAX_PROCESS_ID=0, the heartbeat lease and file bridge at 1 s,
      TPU_DELTA_PERSIST=1, TPU_PROFILE_DIR with a window of steps 1-2);
      SIGKILLed once the heartbeat file shows a durable checkpoint_step
      (and the window's trace is written), which must come before the
      loop's last step, then started again with the
      same command: it exits 0, resumes via storage, its losses on the
      steps both runs printed agree (phase f's tolerance), the heartbeat
      file ends on the last step, its tokens/s, the final checkpoint step
      and the storage restore, and the first run's chrome trace holds
      CUDA kernel events of all four hand-written kernels;
  (k) the MoE family: moe-125m (12 layers, dim 768, 6 heads x 128, 8
      experts, top-2, groups of 256, capacity 80 a group) at full width
      and depth through the entry point under its config's remat policy
      "dots+rope+norms", bs 8, seq 2048: 8 steps with the einsum routing
      (every loss finite, the first within 0.5 of ln(vocab) plus the first
      batch's summed aux loss, launches per step rope 48 and 12 of each
      flash kernel; step time, tokens/s, MFU, peak memory), 3 steps with
      the gather routing (its step time; its losses those of the einsum
      run), and 3 steps FSDP2-sharded on a one-rank NCCL group (the fp32
      router in a group of its own; the same losses); at 2 layers, full
      width, one step's loss and gradients of the two routings (phase f's
      tolerances) and the card (kernels, bf16) against the CPU (plain,
      fp32) at phase d's tolerances, MOE_ROUTED_TOL for the expert and
      router gradient norms, with the share of routes that picked another
      expert; the dispatch and combine einsums of one layer timed; phase
      c's checks and timings at moe-125m's shapes [8, 2048, 6, 128];
  (l) BERT: 2 layers of bert-base at full width, the card (kernels, bf16)
      against the CPU (plain, fp32) at phase d's tolerances (the attention
      key bias, whose exact gradient is 0, held beside the query bias's);
      bert-base at full width and depth through the JAX bench's BERT path
      (make_train_step, train_step.loss_fn with no mask: the non-causal
      head_dim-64 flash kernels and the chunked loss over the tied head
      with its bias; AdamW from make_optimizer), bs 16, seq 512, 1 warm-up
      step and a window of 7: every loss finite, the first within 0.5 of
      ln(30522), launches a step flash_fwd_d64 24 (the forward replayed
      under "dots"), flash_dq_d64 12, flash_dkv_d64 12 and no other; step
      time, tokens/s, MFU and peak memory; then bert_train.main for 4
      steps at bs 16, every printed loss finite;
  (m) the multi-card layer on one card, a one-rank NCCL group: moe-125m
      through the entry point under JAX_MESH_SPEC {"ep": 1} (its experts
      DTensors over ep, the dispatch and the combine through the
      all-to-all, counted: 6 a layer and step under its remat policy) for
      phase k's 8 steps, its losses phase k's einsum run's (LOSS_TOL), at
      phase k's launches; bert-base's data-parallel step on the bench
      path (gradients and loss averaged over the group), phase l's
      batches, losses (LOSS_TOL) and d=64 launches;
  (n) with 2 or more cards, scripts/multicard_smoke.py on all of them
      (llama2-7b at its default fsdp=N, llama-400m over fsdp=N and
      fsdp x tp=2, moe-125m over ep=N, fsdp=N and ep=2 x fsdp, bert-base
      data parallel, a DCP save and restore of the ep=N MoE state, each
      against a one-card run; at 4 cards also llama-400m at seq 8192
      over sp=4, sp=2 x fsdp=2 and sp=2 x tp=2, and at seq 2048 over
      pp=4 (M=4 and M=8), pp=2 x fsdp=2 and pp=2 x tp=2; the multislice
      layout, llama-400m over slice=2 x fsdp=N/2 and dp=2 x fsdp=N/2, and
      over 2 nodes of N/2 cards through the per-node launcher under a
      2-node JAXJob's env, its losses the slice row's; its last 200 lines
      printed); with one card it prints that it did not run and why;
  (o) ring attention's block path on one card: 4 virtual ring ranks run
      in turn at llama-400m's [2, 8192, 8, 128] bf16 (each rank's
      [2, 2048] piece), the full, diagonal and skipped blocks through the
      flash kernels, the lse combine and its backward with dlse; the
      output and dQ/dK/dV against one causal flash call over the whole
      sequence at phase c's tolerances; r + 1 forward, dQ and dK/dV
      launches on ring rank r; each rank's forward and backward ms;
  (p) ResNet and MNIST: resnet50 from one set of seeded weights at bs 2,
      224x224, one training step on the card (bf16, channels_last) against
      the CPU (fp32): the loss and the gradient norms of the convolutions
      and the head at phase d's tolerances, the BatchNorms' gradient
      norms, the whole gradient and each BatchNorm's batch mean and
      variance within RESNET_TOL; resnet_train at resnet50, 224x224, global batch
      256 (a 2-step warm-up run, then 7 steps, the window after the
      first): finite losses, step time, images/s, MFU (3 x the forward's
      convolution and head FLOPs) and peak memory; the host's draw of one
      batch and the step on a resident batch; mnist_train with the
      manifest's arguments
      (--steps=600 --batch=256 --target-accuracy=0.95) must exit 0;
  (q) the per-node launcher on one card: ``python -m tf_operator_tpu_torch.
      runtime.launch --nproc-per-node 1 -- python -m tf_operator_tpu_torch.
      train.llama_train`` with phase e's arguments under the env the
      operator gives the pod of a 1-node JAXJob of one card (:func:`node_env`);
      the run's ``[llama] done`` summary: its 4 losses phase e's (LOSS_TOL)
      at phase e's launches a step of the four kernels;
  (r) the recovery plane: two slice-local worlds share the card through two
      launchers (``--nproc-per-node 1``) under the env of a 2-node,
      2-slice JAXJob with JAX_SLICE_LOCAL_WORLD=1 and TPU_SHARD_SERVER=1
      (:func:`slice_env`), each training llama-400m with phase e's
      arguments from phase g's token file, RECOVERY_STEPS steps, a
      checkpoint every RECOVERY_EVERY; slice 1's launcher is SIGKILLed
      with its child (the process group) after its first durable
      checkpoint and started again with TPU_PEER_RESTORE_ADDRS set to
      slice 0's published address: it must resume through a peer rung
      with slice 0's bytes of that step (the digests of the verified
      checksums and of slice 0's manifest), its losses slice 0's at the
      same steps (LOSS_TOL) at phase e's launches a step, while slice 0
      runs to its end in the same process; both restores' and persists'
      seconds splits and the telemetry families' series (their sums and
      counts, not their buckets) are printed; then
      ``scripts/measure_recovery_torch.py --smoke`` at llama-400m's state,
      one trial a leg, its gates on, its legs' seconds printed;
  (s) the last layouts' new parts at full width, each against its whole
      form in this process: moe-125m's MoE layer at [4, 8192] over 4
      virtual sp ranks (``testing/virtual_ranks.moe_over_sp``), in its
      groups of 256 (inside each rank's piece) and as one group of 8192
      (the ranks' route counts placing each rank's slots), at capacity
      factor 0.5 so that both drop routes, against the layer over the
      whole sequence: output, aux loss and the gradients in x, the
      router and the experts; llama-400m's loss at [8, 2048] x
      32000 over 2 virtual tp shards (``cross_entropy.StackedShards``)
      against the unsharded chunked loss: the loss and its gradients in
      the hidden state and the head; each form's forward and backward ms;
  (t) an elastic job on one card (:func:`phase_t`): llama-400m with phase
      e's arguments from phase g's token file, ELASTIC_STEPS steps, run
      once uninterrupted in this process and once as the pod of an
      elastic 1-node x 1-card ``gpu_job`` through the launcher; after its
      first durable step ``scale()`` to 2 nodes deletes the pod and, 2
      cards not fitting ``--capacity nvidia.com/gpu@h100=1``, leaves the
      job queued; ``scale()`` back to 1 starts it again, and it resumes
      from storage with the uninterrupted run's losses (LOSS_TOL) at phase
      e's launches a step; the restore's seconds and split, and the
      seconds from the scale back to the first resumed step;
  (u) the configurations no earlier phase runs, at full width and depth:
      llama-1b (dim 2048, 16 layers, 16 heads x 128, ffn 5504) through the
      entry point at bs 8, seq 2048, 1 warm-up step and 3 timed steps
      under its config's remat policy, the reference's "dots+rope+norms"
      (rope 64 and 16 of each flash kernel a step), and under "dots" (rope
      96): step time, tokens/s, MFU, peak memory; the two runs' 4 losses
      within 1e-3 relative and one backward's gradients within 1e-2
      relative (L2), as phase f holds them; phase c's checks and timings
      at llama-1b's [8, 2048, 16, 128]; bert-large (24 layers, 16 heads x
      64) on phase l's bench path (48/24/24 d=64 launches a step; step
      time, tokens/s, MFU, peak memory), the d=64 kernels at its [16, 512,
      16, 64] non-causal, and bert_train --model bert-large for 4 steps;
      resnet18 card against CPU at phase p's tolerances and through
      resnet_train at 224x224, global batch 256 (images/s, MFU, peak
      memory);
  (v) the flash kernels at the head dims other than 64 and 128
      (:func:`phase_v`): phase c's checks in all of CASES with d replaced
      by 16, 32 (the 64-wide instances), 80, 96 (the 128-wide ones, their
      tiles' last columns zero-filled), 192 and 256 (the 256-wide ones; at
      192 a whole 64-column box lies past the head dim), each timed at
      [8, 2048, 8, D] causal beside SDPA, the bound at the true D; a
      2-layer llama-tiny of 4 heads of each D trained 2 steps through the
      entry point (launches a step on the instance that serves D); the JAX
      package's tiny configurations (llama-tiny, moe-tiny, bert-tiny: head
      dim 16) card against CPU at PARITY_TOL, and 4 steps on the CPU and
      on the card from the same weights (llama_train; BERT's bench path),
      their losses within PARITY_TOL's loss share, the card's launches on
      the _d64 kernels; llama-400m's widths as 4 heads of 256 (a
      ``LlamaConfig`` built in the phase) through the entry point at bs 8,
      seq 2048, 4 steps (step time, tokens/s, MFU, peak memory, 24 of each
      d256 kernel a step) against the same weights under the plain "xla"
      attention (losses within LOSS_TOL), and one row's backward against
      an fp32 CPU run: the kernels' gradients no further from it than the
      xla run's plus GRAD_TOL, and the same for llama-400m's own 8 x 128
      (:func:`grads_against_fp32`);
  (w) fp32 through the four kernels and the head dims that are a multiple
      of 8 (:func:`phase_w`): phase c's checks in fp32 (rope_f32 and the
      flash_*_f32 instances: the forward, and dQ and dK/dV up to 128
      columns, 3xTF32 on the tensor cores with hi rounded to nearest, dQ
      and dK/dV at 256 FMAs, all at fp32's accuracy; each entry's
      "design" says which) in every
      case of CASES and CASES_D64 at head dims 16, 64, 128 and 256 against
      the fp32 plain versions on the card (TF32 off), at TOL_F32, and at
      head dims 64 and 128 in two large-logit cases (LARGE_LOGIT: q x 8,
      a peaky softmax; causal GQA 8:2 and ragged cross-length), each width's
      instances timed at [8, 2048, 8, D] causal (D = 64, 128, 256) beside
      their plain versions and SDPA in fp32, the bound over a third of the
      TF32 peak (3xTF32, device.tflops_for); the same checks at head dims
      8, 24, 72 and 136 in bf16 (TOL) and fp32 (TOL_F32), each timed at
      [8, 2048, 8, D] in both; a 2-layer llama-tiny of 4 heads of each of
      those trained 2 steps in both dtypes (launches a step on the
      instance that holds the head dim);
      llama-400m in fp32 at full width and depth through the entry point
      (bs 8, seq 2048, "dots", 1 warm-up step and 3 timed steps: 144
      rope_f32 and 24 of each flash_*_f32 launch a step, step time,
      tokens/s, peak memory, MFU against a third of the TF32 peak) with
      its losses within LOSS_TOL_F32 of the same weights under the plain
      fp32 "xla" attention and one row's backward's gradients within
      GRAD_TOL_F32 (rel L2) of that run's; llama-tiny, moe-tiny and
      bert-tiny in fp32 card (kernels) against CPU (plain versions) from
      the same weights, one backward's loss and gradients and 4 steps'
      losses within PARITY_TOL_F32.

Phases e-m, u, v, w and t's in-process run each reset the launch counters
just before their runs and read them just after; the launched runs of q, r and
t count in their own processes and report the counts in their ``[llama]
done`` summaries.
The last lines are the nvidia-smi line, one JSON line of
per-kernel results (launches from phase e, from phase k's einsum run for
the entries named "...[moe-125m]", timed at its shapes, from phase l's
window for the "..._d64" entries, timed at bert-base's, and from phase u's
runs for the entries named "...[llama-1b]" and "..._d64[bert-large]", and
from phase v's runs for those named "...[d<head_dim>]": the 4 x 256 model's
at 256, the 2-layer model's of that head dim otherwise, and from phase w's
runs for the fp32 entries and those at head dims 8, 24, 72 and 136, named
"...[d<head_dim>]": the fp32 llama-400m's at 128, the 2-layer model's of
that head dim and dtype otherwise, of head dim 24 at 64 and 136 at 256), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

MAIN = dict(b=8, s=2048, h=8, kvh=8, d=128, causal=True)  # llama-400m, bs 8
CASES = {
    "main": MAIN,
    "gqa_8_2": dict(b=2, s=512, h=8, kvh=2, d=128, causal=True),
    "non_causal": dict(b=2, s=512, h=8, kvh=8, d=128, causal=False),
    "cross_len": dict(b=2, s=256, s_k=640, h=8, kvh=8, d=128, causal=False),
    "seq_96": dict(b=2, s=96, h=8, kvh=8, d=128, causal=True),
    "seq_200": dict(b=2, s=200, h=8, kvh=8, d=128, causal=True),
    "gqa_8_1_320": dict(b=2, s=320, h=8, kvh=1, d=128, causal=True),
    "cross_ragged": dict(b=2, s=200, s_k=328, h=8, kvh=2, d=128, causal=False),
}
# max |kernel - plain| / max |plain| allowed, in bf16 (unit roundoff 3.9e-3):
# rope does the same fp32 math (1 bf16 rounding apart at most); the flash
# outputs round P and dS to bf16 at the same places as the plain versions,
# but their sums run in other orders (the tolerances of
# tests/test_flash_pallas.py: 2e-2 forward, 5e-2 gradients). lse is fp32.
TOL = {"rope": 1e-2, "o": 2e-2, "lse": 1e-4, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}
# The same in fp32 (unit roundoff 6e-8), both sides fp32 on the card with
# TF32 off: the kernels' sums run in other orders than the plain versions'
# products, over up to 2048 keys; rope does the same fp32 math.
TOL_F32 = {"rope": 1e-5, "o": 1e-4, "lse": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
# Phase (d): bf16 kernels on the card against fp32 plain on the CPU.
PARITY_TOL = {"loss": 1e-2, "grad_norm": 5e-2}
# BERT's attention key bias adds q.b to every score of a query's row, which
# the softmax cancels: its exact gradient is 0. Its card gradient norm is
# held to PARITY_TOL's gradient-norm share of the query bias's.
ZERO_GRAD = ".key.bias"
# Phases (f) and (h): the same bf16 steps under another remat policy, or
# sharded, from the same seed and batches; remat and a one-rank FSDP2
# change no arithmetic, only where its sums may run. A gradient that the
# replay or the sharding got wrong differs by far more.
LOSS_TOL = 1e-3
GRAD_TOL = 1e-2
# --log-every past the last step: the host reads the loss at the first and
# the last step only, the window's two ends.
MAIN_ARGS = ["--model", "llama-400m", "--batch", "8", "--seq", "2048", "--log-every", "100",
             "--warmup", "1"]
ROOT = os.path.dirname(os.path.abspath(__file__))
# The names the hand-written kernels carry in ptxas's report and in a trace.
KERNEL_SYMBOLS = {"rope": "rope_kernel", "flash_fwd": "flash_fwd_kernel",
                  "flash_dq": "flash_dq_kernel", "flash_dkv": "flash_dkv_kernel"}
SOURCES = {
    "rope": ("tf_operator_tpu_torch/ops/csrc/rope.cu", "tf_operator_tpu/ops/rope_pallas.py:54"),
    "flash_fwd": ("tf_operator_tpu_torch/ops/csrc/flash_fwd.cu",
                  "tf_operator_tpu/ops/flash_pallas.py:185"),
    "flash_dq": ("tf_operator_tpu_torch/ops/csrc/flash_dq.cu",
                 "tf_operator_tpu/ops/flash_pallas.py:393"),
    "flash_dkv": ("tf_operator_tpu_torch/ops/csrc/flash_dkv.cu",
                  "tf_operator_tpu/ops/flash_pallas.py:426"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, repeats: int = 3,
            graph: bool = False) -> float:
    """Time of one call: CUDA events around ``iters`` back-to-back calls,
    over the count; the median of ``repeats`` such runs. Events around a
    single short launch would time the host; so would back-to-back calls of
    a kernel shorter than its wrapper's host cost (rope). With ``graph``,
    the ``iters`` calls are captured in one CUDA graph and the events hold
    ``iters`` replays of it, so that the host launches once per ``iters``
    kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    step, calls = fn, iters
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        step, calls = g.replay, iters * iters
        step()
        torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step()
        end.record()
        runs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / calls for s, e in runs)


def host_ms(fn, calls: int = 200) -> float:
    """Host time of one call, the device left to catch up afterwards."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def rel_max_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def check(name: str, case: str, got, ref, tol: float, label: str = "c") -> float:
    err, rel = rel_max_err(got, ref)
    ok = math.isfinite(rel) and rel <= tol
    log(f"[{label}] {case:12s} {name:4s} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version ({case})")
    return err


def case_inputs(c: dict, gen, dev="cuda", dtype=torch.bfloat16):
    """Seeded q, k, v and dO in ``dtype``, and an fp32 dlse, of a case's
    shape."""
    b, s, h, kvh, d = c["b"], c["s"], c["h"], c["kvh"], c["d"]
    s_k = c.get("s_k", s)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    q, k, v = randn(b, s, h, d), randn(b, s_k, kvh, d), randn(b, s_k, kvh, d)
    return q, k, v, randn(b, s, h, d), torch.randn(b, h, s, device=dev, generator=gen)


def check_flash(flash, case, q, k, v, do, dlse, causal, label, tol=TOL) -> dict:
    """The forward, dQ and dK/dV kernels against their plain versions, the
    backward with and without a dlse cotangent; the max abs errors."""
    err = {}
    o, lse = flash.flash_forward_cuda(q, k, v, causal)
    po, plse = flash.flash_forward_plain(q, k, v, causal)
    if o.dtype != q.dtype:
        raise AssertionError(f"flash forward returned {o.dtype} on {q.dtype} inputs")
    err["o"] = check("o", case, o, po, tol["o"], label)
    err["lse"] = check("lse", case, lse, plse, tol["lse"], label)
    for tag, cot in (("", None), ("+dlse", dlse)):
        delta = flash.flash_delta(do, o, cot)
        dq = flash.flash_dq_cuda(q, k, v, do, lse, delta, causal)
        pdq = flash.flash_dq_plain(q, k, v, do, lse, delta, causal)
        dk, dv = flash.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
        pdk, pdv = flash.flash_dkv_plain(q, k, v, do, lse, delta, causal)
        if not dq.dtype == dk.dtype == dv.dtype == q.dtype:
            raise AssertionError(f"flash backward returned {dq.dtype}, {dk.dtype}, "
                                 f"{dv.dtype} on {q.dtype} inputs")
        err["dq" + tag] = check("dq", case + tag, dq, pdq, tol["dq"], label)
        err["dk" + tag] = check("dk", case + tag, dk, pdk, tol["dk"], label)
        err["dv" + tag] = check("dv", case + tag, dv, pdv, tol["dv"], label)
    return err


def kernel_result(name, source, kern, plain, lib, nbytes, flops, err, peak, label,
                  graph=False, case="", dtype=torch.bfloat16) -> dict:
    """One entry of the kernels line: the kernel's, its plain version's and
    the library call's times at one shape, and its bound there (its FLOPs
    over ``dtype``'s peak, device.tflops_for); with ``graph`` the kernel
    and the library call are timed in a CUDA graph (time_ms), as rope
    always is."""
    from tf_operator_tpu_torch.device import tflops_for

    t_bytes = nbytes / (peak.hbm_tbps * 1e12) * 1e3
    t_ops = flops / (tflops_for(peak, dtype) * 1e12) * 1e3
    res = {
        "name": name, "route": "cuda", "source": SOURCES[source][0],
        "replaces": SOURCES[source][1], "launches": None, "max_abs_err": err,
        "ms": time_ms(kern, graph=graph or source == "rope"),
        "plain_ms": time_ms(plain, iters=5, warmup=1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": time_ms(lib, graph=graph) if lib is not None else None,
    }
    log(f"[{label}] {case}{name}: {res['ms']:.4f} ms, {res['bound_ms'] / res['ms']:.3f} of its "
        f"bound (plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}, library {res['library_ms']}) bytes {nbytes} flops {flops}")
    return res


def phase_c(flash, rope_mod, peak, cases=CASES, dev="cuda", main="main", label="c",
            dtype=torch.bfloat16, tol=TOL):
    """Each kernel against its plain version on ``dtype`` inputs, at
    ``tol``; returns per-kernel results at the shapes of the case named
    ``main``. Lines carry ``[label]``."""
    from tf_operator_tpu_torch.models.llama import rope_table

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for case, c in cases.items():
        b, s, h, kvh, d = c["b"], c["s"], c["h"], c["kvh"], c["d"]
        s_k = c.get("s_k", s)
        q, k, v, do, dlse = case_inputs(c, gen, dev, dtype)
        cos, sin = rope_table(d, s, 10000.0, dev)

        err = {}
        out = rope_mod.rope_cuda(q, cos, sin)
        if out.dtype != dtype:
            raise AssertionError(f"rope returned {out.dtype} on {dtype} x")
        err["rope"] = check("rope", case, out, rope_mod.rope_plain(q, cos, sin), tol["rope"],
                            label)
        err["rope_bwd"] = check("rope", case + "-bwd", rope_mod.rope_cuda(do, cos, sin, True),
                                rope_mod.rope_plain(do, cos, sin, True), tol["rope"], label)
        causal = c["causal"]
        err.update(check_flash(flash, case, q, k, v, do, dlse, causal, label, tol))
        if case != main:
            continue
        o, lse = flash.flash_forward_cuda(q, k, v, causal)

        delta = flash.flash_delta(do, o)
        fw = flash.flash_work(b, s, s_k, h, kvh, d, causal, q.element_size())
        work = {
            # name: (kernel, plain, library, bytes moved, tensor-core flops)
            "rope": (lambda: rope_mod.rope_cuda(q, cos, sin),
                     lambda: rope_mod.rope_plain(q, cos, sin), None,
                     *rope_mod.rope_work(b, s, h, d, q.element_size())),
            "flash_fwd": (lambda: flash.flash_forward_cuda(q, k, v, causal),
                          lambda: flash.flash_forward_plain(q, k, v, causal),
                          lambda: torch.nn.functional.scaled_dot_product_attention(
                              q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              is_causal=causal),
                          *fw["flash_fwd"]),
            "flash_dq": (lambda: flash.flash_dq_cuda(q, k, v, do, lse, delta, causal),
                         lambda: flash.flash_dq_plain(q, k, v, do, lse, delta, causal), None,
                         *fw["flash_dq"]),
            "flash_dkv": (lambda: flash.flash_dkv_cuda(q, k, v, do, lse, delta, causal),
                          lambda: flash.flash_dkv_plain(q, k, v, do, lse, delta, causal),
                          None, *fw["flash_dkv"]),
        }
        errs = {"rope": max(err["rope"], err["rope_bwd"]),
                "flash_fwd": max(err["o"], err["lse"]),
                "flash_dq": max(err["dq"], err["dq+dlse"]),
                "flash_dkv": max(err["dk"], err["dv"], err["dk+dlse"], err["dv+dlse"])}
        for name, (kern, plain, lib, nbytes, flops) in work.items():
            results[name] = kernel_result(name, name, kern, plain, lib, nbytes, flops,
                                          errs[name], peak, label, dtype=dtype)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)
        bwd_ms = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
        ours = results["flash_dq"]["ms"] + results["flash_dkv"]["ms"]
        log(f"[{label}] yardstick: scaled_dot_product_attention's backward alone (dQ, dK and dV "
            f"in one call, its forward saved) {bwd_ms:.4f} ms; flash_dq + flash_dkv "
            f"{ours:.4f} ms, {ours / bwd_ms:.3f}x its time")
        del qt, kt, vt, ot
        rope = work["rope"][0]
        log(f"[{label}] rope by events over back-to-back calls {time_ms(rope):.4f} ms; host cost "
            f"of a rope_cuda call {host_ms(rope):.4f} ms; yardstick, a copy of x (the same "
            f"bytes less the tables) {time_ms(lambda: q.clone(), graph=True):.4f} ms in a "
            f"graph, {time_ms(lambda: q.clone()):.4f} ms by events")
    return results


# Phase (c) at head_dim 64, the d=64 instances of the flash kernels: bert-
# base's own shape (bs 16, seq 512, 12 heads x 64, non-causal, the shape
# phase l trains at), and causal, causal GQA 12:4 ending inside a 128-row
# tile, and non-causal cross-length cases with both lengths ragged.
BERT_SHAPE = dict(b=16, s=512, h=12, kvh=12, d=64, causal=False)
CASES_D64 = {
    "bert_base": BERT_SHAPE,
    "d64_causal": dict(b=4, s=512, h=12, kvh=12, d=64, causal=True),
    "d64_gqa_320": dict(b=4, s=320, h=12, kvh=4, d=64, causal=True),
    "d64_ragged": dict(b=4, s=200, s_k=328, h=12, kvh=12, d=64, causal=False),
}


def sdpa(q, k, v, causal):
    """torch's scaled_dot_product_attention on BSHD tensors (the yardstick;
    the port never calls it)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
        enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def phase_c64(flash, peak, cases=CASES_D64, main="bert_base", label="c") -> dict:
    """The head_dim-64 kernels against their plain versions in every case
    of ``cases``, each case timed: each kernel, its plain version, its
    bound and share, SDPA's forward and its forward and backward; returns
    the entries of the case named ``main``. The kernels and SDPA are timed in
    CUDA graphs: at these sizes a call's host cost (a wrapper's tensor
    maps and allocations, autograd's graph) is near or above its device
    time, and back-to-back calls by events would time the host."""
    gen = torch.Generator(device="cuda").manual_seed(64)
    results = {}
    for case, c in cases.items():
        b, s, h, kvh, d, causal = c["b"], c["s"], c["h"], c["kvh"], c["d"], c["causal"]
        s_k = c.get("s_k", s)
        q, k, v, do, dlse = case_inputs(c, gen)
        err = check_flash(flash, case, q, k, v, do, dlse, causal, label)
        o, lse = flash.flash_forward_cuda(q, k, v, causal)
        delta = flash.flash_delta(do, o)
        fw = flash.flash_work(b, s, s_k, h, kvh, d, causal)
        work = {
            "flash_fwd": (lambda: flash.flash_forward_cuda(q, k, v, causal),
                          lambda: flash.flash_forward_plain(q, k, v, causal),
                          lambda: sdpa(q, k, v, causal), max(err["o"], err["lse"])),
            "flash_dq": (lambda: flash.flash_dq_cuda(q, k, v, do, lse, delta, causal),
                         lambda: flash.flash_dq_plain(q, k, v, do, lse, delta, causal), None,
                         max(err["dq"], err["dq+dlse"])),
            "flash_dkv": (lambda: flash.flash_dkv_cuda(q, k, v, do, lse, delta, causal),
                          lambda: flash.flash_dkv_plain(q, k, v, do, lse, delta, causal), None,
                          max(err["dk"], err["dv"], err["dk+dlse"], err["dv+dlse"])),
        }
        entries = {}
        for kernel, (kern, plain, lib, e) in work.items():
            name = flash.kernel_name(kernel, d)
            entries[name] = kernel_result(name, kernel, kern, plain, lib, *fw[kernel], e, peak,
                                          label, graph=True, case=f"[{case}] ")
        qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa_both():
            return torch.autograd.grad(sdpa(qt, kt, vt, causal), (qt, kt, vt), do)

        both_ms = time_ms(sdpa_both, graph=True)
        ours = sum(r["ms"] for r in entries.values())
        log(f"[{label}] [{case}] {[b, s, s_k, h, kvh, d]} causal={causal}: forward, dQ and "
            f"dK/dV {ours:.4f} ms against SDPA's forward and backward {both_ms:.4f} ms "
            f"({ours / both_ms:.3f}x its time; by events without a graph: ours "
            f"{sum(time_ms(w[0]) for w in work.values()):.4f} ms, SDPA "
            f"{time_ms(sdpa_both):.4f} ms)")
        if case == main:
            for r in entries.values():
                r["sdpa_fwd_bwd_ms"] = both_ms
            results = entries
        del q, k, v, do, dlse, o, lse, delta, qt, kt, vt
    return results


def phase_d():
    """2 layers at llama-400m width: card (kernels, bf16) vs CPU (plain, fp32)."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.train.data import SyntheticTokens

    cfg = dataclasses.replace(llama.CONFIGS["llama-400m"], n_layers=2, max_seq_len=2048)
    tokens = torch.from_numpy(next(SyntheticTokens(1, 2048, cfg.vocab_size, seed=1))).long()
    card_cpu_parity("d", llama.Llama, cfg, tokens)


def card_cpu_parity(label: str, model_cls, cfg, tokens) -> None:
    """``loss_fn``'s loss and every parameter's gradient norm of one model
    from one set of seeded weights: on the card (kernels, bf16) against the
    CPU (plain versions, fp32), within PARITY_TOL."""
    from tf_operator_tpu_torch.train.train_step import loss_fn

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    cpu_model = model_cls(cpu_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = model_cls(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())

    t0 = time.perf_counter()
    gpu_loss = loss_fn(gpu_model, tokens.cuda())
    gpu_loss.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_loss = loss_fn(cpu_model, tokens)
    cpu_loss.backward()
    t2 = time.perf_counter()
    log(f"[{label}] loss card {gpu_loss.item():.6f} cpu {cpu_loss.item():.6f} "
        f"(card {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
    rel = abs(gpu_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    if not rel <= PARITY_TOL["loss"]:
        raise AssertionError(f"loss differs by {rel:.3e} relative")
    cpu_params = dict(cpu_model.named_parameters())
    worst, worst_name, noise, noise_name = 0.0, "", 0.0, ""
    for name, p in gpu_model.named_parameters():
        g, ref = p.grad.float().norm().item(), cpu_params[name].grad.norm().item()
        if name.endswith(ZERO_GRAD):
            # Its exact gradient is 0, so both norms are rounding noise: the
            # card's must stay small beside the query bias's.
            q = cpu_params[name.replace(ZERO_GRAD, ".query.bias")].grad.norm().item()
            if not g / max(q, 1e-30) <= noise:
                noise, noise_name = g / max(q, 1e-30), name
            continue
        r = abs(g - ref) / max(ref, 1e-30)
        if not r <= worst:
            worst, worst_name = r, name
    log(f"[{label}] loss rel {rel:.3e} (tol {PARITY_TOL['loss']}); worst grad-norm rel "
        f"{worst:.3e} at {worst_name} (tol {PARITY_TOL['grad_norm']})"
        + (f"; largest zero-gradient norm {noise:.3e} of the query bias's, at {noise_name}"
           if noise_name else ""))
    if not worst <= PARITY_TOL["grad_norm"] or not noise <= PARITY_TOL["grad_norm"]:
        raise AssertionError(f"gradient norm of {worst_name} differs by {worst:.3e}, or "
                             f"{noise_name}'s is {noise:.3e} of its query bias's")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()


def expected_launches(policy: str, layers: int, head_dim: int = 128,
                       remat: bool = True, attention: str = "pallas",
                       dtype=torch.bfloat16) -> dict:
    """Kernel launches per training step: the forward's two ropes and one
    flash forward per layer, the backward's two ropes, dQ and dK/dV, and
    the replay of what the policy does not save (nothing without remat),
    on the instances that serve ``head_dim`` and ``dtype`` (no flash kernel
    under the plain "xla" attention); every other kernel 0."""
    from tf_operator_tpu_torch.ops import build, flash, rope

    saved = set(policy.split("+")) if remat else {"dots", "rope"}
    want = dict.fromkeys(build.KERNELS, 0)
    want[rope.kernel_name(dtype)] = (4 if "rope" in saved else 6) * layers
    if attention != "xla":
        fwd = flash.kernel_name("flash_fwd", head_dim, dtype)
        want[fwd] = (1 if "dots" in saved else 2) * layers
        want[flash.kernel_name("flash_dq", head_dim, dtype)] = layers
        want[flash.kernel_name("flash_dkv", head_dim, dtype)] = layers
    return want


def train_run(build, peak, phase: str, argv: list, config=None) -> dict:
    """One llama_train run (of ``config`` in place of its ``--model``'s,
    when given) with the launch counters and the peak device memory reset
    just before it and read just after; prints and returns losses, the
    step time of its window (from the host's read of the first step's loss
    to its read of the last's), tokens/s, MFU, peak memory and launches."""
    from tf_operator_tpu_torch.device import tflops_for
    from tf_operator_tpu_torch.train import llama_train

    gc.collect()
    torch.cuda.empty_cache()
    args = llama_train.parse_args(argv)
    setup = llama_train.setup(args, config=config) if config is not None else None
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = llama_train.run(args, setup)
    del setup
    out["launches"] = dict(build.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    steps = len(out["losses"])
    if out["window_steps"] < 1:
        raise AssertionError(f"a window of {out['window_steps']} steps times nothing")
    out["step_s"] = out["window_seconds"] / out["window_steps"]
    out["tokens_per_s"] = out["tokens_per_step"] / out["step_s"]
    # fp32 runs are scored against a third of the TF32 peak (3xTF32).
    tflops = tflops_for(peak, out["config"].dtype)
    out["mfu"] = out["tokens_per_s"] * out["config"].flops_per_token(args.seq) / (tflops * 1e12)
    out["per_step"] = {k: n / steps for k, n in out["launches"].items()}
    policy = out["config"].remat_policy
    log(f"[{phase}] remat_policy {policy}: losses {out['losses']}")
    log(f"[{phase}] remat_policy {policy}: window of {out['window_steps']} steps in "
        f"{out['window_seconds']:.4f} s (the first step, the warm-up, outside); step "
        f"{out['step_s']:.4f} s, tokens/s "
        f"{out['tokens_per_s']:.1f}, MFU {out['mfu']:.4f} (peak {tflops:g} TFLOP/s, "
        f"{out['config'].dtype}); peak device memory {out['peak_gib']:.3f} GiB")
    log(f"[{phase}] remat_policy {policy}: launches in {steps} steps {out['launches']}, "
        f"per step {out['per_step']}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss {out['losses']}")
    cfg = out["config"]
    want = expected_launches(policy, cfg.n_layers, cfg.head_dim, cfg.remat, cfg.attention_impl,
                             cfg.dtype)
    if out["per_step"] != want:
        raise AssertionError(f"launches per step {out['per_step']}, expected {want}")
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_e(build, peak) -> dict:
    """The main path: llama-400m through the llama_train entry point."""
    out = train_run(build, peak, "e", [*MAIN_ARGS, "--steps", "4"])
    if abs(out["losses"][0] - math.log(out["config"].vocab_size)) > 0.5:
        raise AssertionError(f"first loss {out['losses'][0]} is far from ln(vocab)")
    return out


def first_grads(argv: list) -> dict:
    """Every parameter's gradient (whole, for a sharded model) after one
    forward and backward on the run's first batch, from the entry point's
    own setup."""
    from torch.distributed.tensor import DTensor

    from tf_operator_tpu_torch.train import llama_train
    from tf_operator_tpu_torch.train.train_step import loss_fn

    gc.collect()
    s = llama_train.setup(llama_train.parse_args(argv))
    model = s.state.model
    tokens = torch.as_tensor(next(s.dataset)).to(device=s.batches.device, dtype=torch.long)
    loss_fn(model, tokens).backward()
    grads = {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad).detach()
             for n, p in model.named_parameters()}
    del s, model
    return grads


def check_grads(phase: str, what: str, got: dict, ref: dict) -> None:
    """Each gradient within GRAD_TOL of its reference, in relative L2."""
    worst, worst_name = 0.0, ""
    for name, g in got.items():
        r = ((g.float() - ref[name].float()).norm() / ref[name].float().norm().clamp(min=1e-30)).item()
        if not r <= worst:
            worst, worst_name = r, name
    log(f"[{phase}] {what}: worst gradient rel L2 {worst:.3e} at {worst_name} over "
        f"{len(got)} parameters (tol {GRAD_TOL})")
    if len(got) != len(ref) or not worst <= GRAD_TOL:
        raise AssertionError(f"{what}: gradient of {worst_name} differs by {worst:.3e}")


def check_losses(phase: str, what: str, got: list, ref: list) -> None:
    """Every loss within LOSS_TOL of its reference."""
    worst = max(rel(a, b) for a, b in zip(got, ref))
    log(f"[{phase}] {what}: losses {got} against {ref}: worst rel {worst:.3e} (tol {LOSS_TOL})")
    if len(got) != len(ref) or not worst <= LOSS_TOL:
        raise AssertionError(f"{what}: losses differ by {worst:.3e}")


def phase_f(build, peak) -> dict:
    """The remat policies' trade: step time, peak memory, launches; their
    losses and gradients agree. Returns "dots"'s first gradients."""
    runs = {p: train_run(build, peak, "f", [*MAIN_ARGS, "--steps", "4", "--remat-policy", p])
            for p in ("nothing", "dots", "dots+rope")}
    base = runs["nothing"]
    for policy, out in runs.items():
        log(f"[f] {policy:10s} step {out['step_s']:.4f} s ({base['step_s'] / out['step_s']:.3f}x "
            f"'nothing'), peak {out['peak_gib']:.3f} GiB ({out['peak_gib'] - base['peak_gib']:+.3f}), "
            f"launches/step {out['per_step']}")
        check_losses("f", f"{policy} against 'nothing'", out["losses"], base["losses"])
    ref = first_grads([*MAIN_ARGS, "--remat-policy", "nothing"])
    for policy in ("dots", "dots+rope"):
        grads = first_grads([*MAIN_ARGS, "--remat-policy", policy])
        check_grads("f", f"{policy} against 'nothing'", grads, ref)
        if policy == "dots":
            dots = grads
        del grads
    return dots


def seeded_tokens(directory: str, tokens: int = 4_000_000, vocab: int = 32000) -> str:
    """A uint16 token file of ``tokens`` ids below ``vocab`` from seed 0."""
    import numpy as np

    from tf_operator_tpu_torch.train import data

    path = os.path.join(directory, "tokens.bin")
    data.write_token_file(path, np.random.default_rng(0).integers(0, vocab, tokens)
                          .astype(np.uint16))
    return path


def phase_g(build, peak):
    """Token-file data through the native loader and the device prefetch."""
    from tf_operator_tpu_torch.train import data, llama_train

    with tempfile.TemporaryDirectory() as tmp:
        path = seeded_tokens(tmp)
        native = data.TokenFileDataset(path, 8, 2048, dtype="uint16")
        plain = data.TokenFileDataset(path, 8, 2048, dtype="uint16", force_python=True)
        same = all(next(native).tobytes() == next(plain).tobytes() for _ in range(3))
        ran = native.native
        log(f"[g] native loader ran: {ran}; 3 batches byte-equal to the Python path: {same}")
        native.close()
        if not ran:
            raise AssertionError("the native loader did not build or load")
        if not same:
            raise AssertionError("the native loader's batches differ from the Python path's")
        argv = [*MAIN_ARGS, "--steps", "3", "--data", path, "--data-dtype", "uint16"]
        on = train_run(build, peak, "g", argv)
        log(f"[g] llama_train --data: native loader {on['native_loader']}")
        if not on["native_loader"]:
            raise AssertionError("llama_train --data did not run the native loader")
        gc.collect()
        s = llama_train.setup(llama_train.parse_args(argv))
        state, off = s.state, []
        for _ in range(3):
            state, loss = s.step_fn(state, next(s.dataset))  # host batches, no prefetch
            off.append(float(loss))
        del s, state
        log(f"[g] losses with prefetch {on['losses']}, without {off}")
        if on["losses"] != off:
            raise AssertionError("prefetch changed the losses")


def phase_h(build, peak, main_losses: list, main_grads: dict) -> dict:
    """The FSDP2-sharded step on a one-rank NCCL group: phase e's losses,
    and phase f's "dots" gradients."""
    import torch.distributed as dist

    one_rank_group()
    os.environ["JAX_MESH_SPEC"] = '{"fsdp": 1}'
    try:
        out = train_run(build, peak, "h", [*MAIN_ARGS, "--steps", "4"])
        grads = first_grads(MAIN_ARGS)
    finally:
        del os.environ["JAX_MESH_SPEC"]
        dist.destroy_process_group()
    if out["mesh"] != {"fsdp": 1}:
        raise AssertionError(f"sharded run on mesh {out['mesh']}")
    check_losses("h", "FSDP2 against phase e", out["losses"], main_losses)
    check_grads("h", "FSDP2 against unsharded 'dots'", grads, main_grads)
    return out


def bits_equal(got: dict, want: dict) -> bool:
    """Every tensor of ``got`` bit-equal to ``want``'s of the same name."""
    def raw(t):
        return t.detach().reshape(-1).view(torch.uint8).cpu()

    return got.keys() == want.keys() and all(torch.equal(raw(got[n]), raw(want[n]))
                                             for n in want)


def blank(state) -> None:
    """Zero every tensor of a train state, its step and its count."""
    from tf_operator_tpu_torch.runtime.shard_server import flatten_state

    with torch.no_grad():
        for t in flatten_state(state).values():
            t.zero_()
    state.step = state.opt_state.count = 0


def torn_check(base: list, tmp: str) -> None:
    """A save whose persist is held while the next step is enqueued at once:
    the persisted bytes must be the state at the save."""
    from tf_operator_tpu_torch.runtime.shard_server import decode_shard, flatten_state
    from tf_operator_tpu_torch.train import llama_train
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    gc.collect()
    s = llama_train.setup(llama_train.parse_args([*base, "--steps", "4"]))
    state, _ = s.step_fn(s.state, next(s.batches))
    with CheckpointManager(os.path.join(tmp, "torn"), model_meta=s.config.geometry()) as mgr:
        gate = threading.Event()
        mgr._persist_gate = lambda _step: gate.wait(600)
        try:
            want = {n: t.clone() for n, t in flatten_state(state).items()}
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            mgr.save(state)
            blocked = time.perf_counter() - t0
            end.record()
            state, _ = s.step_fn(state, next(s.batches))  # in place, not waited for
            torch.cuda.synchronize()
            copy_ms = start.elapsed_time(end)
            moved = sum(not torch.equal(t, want[n]) for n, t in flatten_state(state).items())
        finally:
            gate.set()  # close() drains the persist: never leave it held
        mgr.wait()
        manifest = mgr._read_delta_manifest(1)
        persisted = {}
        for name, entry in manifest["shards"].items():
            with open(os.path.join(mgr._delta_shards_dir, f"{entry['checksum']}.npy"), "rb") as f:
                persisted[name] = decode_shard(f.read(), want[name].dtype)
        equal = bits_equal(persisted, want)
    log(f"[i] torn-snapshot check: save() blocked {blocked:.4f} s, the snapshot's copies "
        f"took {copy_ms:.3f} ms on the device; the next step changed {moved} of "
        f"{len(want)} tensors; persisted step-1 bytes equal the state at the save: {equal}")
    n = len(want)
    del s, state, want, persisted
    if not equal or moved < n // 2:
        raise AssertionError("the persisted snapshot is not the state at the save")


def phase_i(build, peak, main_args=MAIN_ARGS) -> None:
    """Checkpoint, resume and peer restore at full width and depth."""
    from tf_operator_tpu_torch.runtime.shard_server import flatten_state, start_shard_server
    from tf_operator_tpu_torch.train import llama_train
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.restore import restore_with_fallback

    with tempfile.TemporaryDirectory() as tmp:
        path = seeded_tokens(tmp)
        base = [*main_args, "--data", path, "--data-dtype", "uint16"]
        ckdir = os.path.join(tmp, "ckpt")
        u = train_run(build, peak, "i", [*base, "--steps", "4"])
        a = train_run(build, peak, "i", [*base, "--steps", "2", "--checkpoint-dir", ckdir])
        mgr = a["ckpt"]
        info = mgr.last_persist_info
        log(f"[i] A: save() blocked the loop {a['save_seconds']} s; persist to the "
            f"durability edge {mgr.last_persist_seconds:.3f} s; {info}")
        if mgr.last_durable_step() != 2 or info["step"] != 2 or a["restore"].path != "none":
            raise AssertionError(f"A: durable {mgr.last_durable_step()}, {info}, "
                                 f"restore {a['restore']}")
        stored = sum(e["bytes"] for e in mgr._read_delta_manifest(2)["shards"].values())

        # The storage restore B makes: llama_train's setup on D.
        gc.collect()
        b_args = [*base, "--steps", "4", "--checkpoint-dir", ckdir]
        sb = llama_train.setup(llama_train.parse_args(b_args))
        sb.ckpt.close()
        out = sb.restore
        log(f"[i] storage: {(out.path, out.cause, out.step)} in {out.seconds:.3f} s, "
            f"{stored} bytes")
        if (out.path, out.cause, out.step) != ("storage", "ok", 2):
            raise AssertionError(f"storage restore {out}")
        ref = {n: t.clone() for n, t in flatten_state(sb.state).items()}
        srv = start_shard_server(mgr)
        empty = CheckpointManager(os.path.join(tmp, "empty"), model_meta=sb.config.geometry())
        try:
            for sharded, want in ((False, "peer"), (True, "peer-sharded")):
                blank(sb.state)
                out = restore_with_fallback(sb.state, empty, [srv.address], sharded=sharded)
                equal = bits_equal(flatten_state(sb.state), ref)
                log(f"[i] {want}: {(out.path, out.cause, out.step)} in {out.seconds:.3f} s, "
                    f"{out.bytes_moved} bytes over the wire; byte-equal to storage: {equal}")
                if (out.path, out.cause, out.step) != (want, "ok", 2) or not equal:
                    raise AssertionError(f"{want} restore {out}, byte-equal {equal}")
        finally:
            srv.stop()
        del sb, ref, mgr, a

        b = train_run(build, peak, "i", b_args)
        out = b["restore"]
        if (out.path, out.cause, out.step, b["start_step"]) != ("storage", "ok", 2, 2):
            raise AssertionError(f"B resumed {out}, from step {b['start_step']}")
        check_losses("i", "B's steps 2-3 against U's", b["losses"], u["losses"][2:])
        log(f"[i] B: save() blocked {b['save_seconds']} s; persist "
            f"{b['ckpt'].last_persist_seconds:.3f} s; {b['ckpt'].last_persist_info}")
        del b
        torn_check(base, tmp)


# Phase (k): moe-125m (the JAX bench's MoE secondary) at full width and
# depth, its config's remat policy "dots+rope+norms", groups of 256.
MOE_ARGS = ["--model", "moe-125m", "--batch", "8", "--seq", "2048", "--log-every", "100",
            "--warmup", "1"]
MOE_SHAPE = dict(b=8, s=2048, h=6, kvh=6, d=128, causal=True)
# Card (bf16) against CPU (fp32) for the expert weights and the router:
# bf16 rounds the router's input, which flips the top-2 choice of the
# routes whose 2nd and 3rd scores are near-tied, and moves those tokens'
# gradient from one expert to another (and the capacity race after them).
# Twice PARITY_TOL's gradient-norm bound; the share of flipped routes is
# printed beside it.
MOE_ROUTED_TOL = 1e-1


def moe_config(**changes):
    from tf_operator_tpu_torch.models import llama

    return dataclasses.replace(llama.CONFIGS["moe-125m"], max_seq_len=2048, **changes)


def moe_grads(cfg, tokens, device="cuda", routes=None, state=None):
    """(loss, {name: gradient}) of one forward and backward of a model of
    ``cfg`` on ``device``, drawn from seed 0 there or given ``state``; with
    ``routes``, a dict that receives each layer's top-k expert ids of its
    first forward."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.train.train_step import loss_fn

    gc.collect()
    model = llama.Llama(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    if routes is not None:
        for i, layer in enumerate(model.layers):
            def keep(module, args, out, i=i):
                routes.setdefault(i, torch.topk(out, cfg.experts_per_token)[1].cpu())
            layer.feed_forward.router.register_forward_hook(keep)
    loss = loss_fn(model, tokens.to(device))
    loss.backward()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    return loss.item(), grads


def moe_parity(tokens, cfg=None, label: str = "k") -> None:
    """Two layers at full width (or ``cfg``): the card (kernels, bf16)
    against the CPU (plain versions, fp32), from the same weights."""
    from tf_operator_tpu_torch.models import llama

    cfg = cfg or moe_config(n_layers=2)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    state = llama.Llama(cpu_cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    card_routes, cpu_routes = {}, {}
    t0 = time.perf_counter()
    card_loss, card = moe_grads(cfg, tokens, "cuda", card_routes, state)
    t1 = time.perf_counter()
    cpu_loss, cpu = moe_grads(cpu_cfg, tokens, "cpu", cpu_routes, state)
    t2 = time.perf_counter()
    flipped = [(card_routes[i] != cpu_routes[i]).float().mean().item() for i in cpu_routes]
    rel_loss = rel(card_loss, cpu_loss)
    log(f"[{label}] parity at {cfg.n_layers} layers: loss card {card_loss:.6f} cpu "
        f"{cpu_loss:.6f}, rel "
        f"{rel_loss:.3e} (tol {PARITY_TOL['loss']}); share of (token, rank) routes whose "
        f"expert differs per layer {flipped} (card {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
    if not rel_loss <= PARITY_TOL["loss"]:
        raise AssertionError(f"moe loss differs by {rel_loss:.3e} relative")
    worst = {}
    for name, g in card.items():
        routed = ".router." in name or ".experts_" in name
        r = rel(g.float().norm().item(), cpu[name].norm().item())
        if r >= worst.get(routed, (0.0, ""))[0]:
            worst[routed] = (r, name)
    (dense, dense_name), (routed, routed_name) = worst[False], worst[True]
    log(f"[{label}] parity at {cfg.n_layers} layers: worst grad-norm rel {dense:.3e} at "
        f"{dense_name} (tol "
        f"{PARITY_TOL['grad_norm']}); experts and router {routed:.3e} at {routed_name} "
        f"(tol {MOE_ROUTED_TOL})")
    if not dense <= PARITY_TOL["grad_norm"] or not routed <= MOE_ROUTED_TOL:
        raise AssertionError(f"moe gradient norms differ: {worst}")


def routing_ms(x, cfg) -> tuple[float, float]:
    """(forward, forward and backward) ms of one MoE layer's dispatch and
    combine einsums at ``x``'s shape, on routes from a seeded router and
    experts left out (their output is their input)."""
    b, s, d = x.shape
    group = cfg.moe_group_size
    xg = x.reshape(b * s // group, group, d)
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = int(cfg.capacity_factor * group * k / e)
    gen = torch.Generator(device="cuda").manual_seed(3)
    probs = torch.softmax(torch.randn(*xg.shape[:2], e, device="cuda", generator=gen), -1)
    gate, idx = torch.topk(probs, k)
    onehot = torch.nn.functional.one_hot(idx, e)
    taken, combine = 0, 0
    for j in range(k):
        oh = onehot[:, :, j]
        pos = oh.cumsum(1) - oh + taken
        keep = ((pos < cap) & (oh > 0)).to(x.dtype) * gate[:, :, j, None].to(x.dtype)
        combine = combine + keep[..., None] * (
            pos.clamp(max=cap - 1)[..., None] == torch.arange(cap, device="cuda")).to(x.dtype)
        taken = taken + oh.sum(1, keepdim=True)
    dispatch = (combine > 0).to(x.dtype)
    combine = combine.detach().requires_grad_()
    xg = xg.detach().requires_grad_()

    def forward():
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, xg)
        return torch.einsum("bsec,ebcd->bsd", combine, expert_in)

    dy = torch.randn_like(xg)
    fwd = time_ms(forward)
    both = time_ms(lambda: torch.autograd.grad(forward(), (xg, combine), dy))
    return fwd, both


def phase_k(build, peak, flash, rope_mod) -> dict:
    """moe-125m on the card: the entry point at full width and depth (einsum
    routing 8 steps, gather routing 3), einsum against gather and card
    against CPU at 2 layers, one-rank FSDP2, and the kernels at its shapes.
    Returns the kernels' results at moe-125m's shapes with the launches of
    its main run, and that run's losses."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.train import llama_train
    from tf_operator_tpu_torch.train.data import SyntheticTokens

    # The first batch's load-balancing losses, from the run's own setup.
    gc.collect()
    s = llama_train.setup(llama_train.parse_args([*MOE_ARGS, "--steps", "8"]))
    model = s.state.model
    router = model.layers[0].feed_forward.router.weight
    tokens = torch.as_tensor(next(s.dataset)).to(device=s.batches.device, dtype=torch.long)
    with torch.no_grad():
        aux0 = model(tokens[:, :-1], return_hidden=True, return_aux=True)[1].item()
    log(f"[k] moe-125m: {s.config.param_count():,} parameters, "
        f"{s.config.active_param_count():,} active; router {router.dtype}, experts "
        f"{model.layers[0].feed_forward.experts_w1.dtype}; the first batch's summed aux "
        f"loss {aux0:.6f}")
    if router.dtype != torch.float32:
        raise AssertionError(f"router in {router.dtype}")
    del s, model, router, tokens

    main = train_run(build, peak, "k", [*MOE_ARGS, "--steps", "8"])
    want = math.log(main["config"].vocab_size) + aux0
    if abs(main["losses"][0] - want) > 0.5:
        raise AssertionError(f"first loss {main['losses'][0]} is far from ln(vocab) + aux {want}")

    einsum_cfg = llama.CONFIGS["moe-125m"]
    llama.CONFIGS["moe-125m"] = dataclasses.replace(einsum_cfg, moe_impl="gather")
    try:
        gather = train_run(build, peak, "k", [*MOE_ARGS, "--steps", "3"])
    finally:
        llama.CONFIGS["moe-125m"] = einsum_cfg
    log(f"[k] einsum against gather routing, 12 layers: step {main['step_s']:.4f} s against "
        f"{gather['step_s']:.4f} s ({gather['step_s'] / main['step_s']:.3f}x), peak "
        f"{main['peak_gib']:.3f} against {gather['peak_gib']:.3f} GiB")
    check_losses("k", "gather against einsum, 12 layers", gather["losses"], main["losses"][:3])

    batch = torch.from_numpy(next(SyntheticTokens(8, 2048, 32000, seed=1))).long()
    loss_e, grads_e = moe_grads(moe_config(n_layers=2), batch)
    loss_g, grads_g = moe_grads(moe_config(n_layers=2, moe_impl="gather"), batch)
    check_losses("k", "gather against einsum, 2 layers", [loss_g], [loss_e])
    check_grads("k", "gather against einsum, 2 layers", grads_g, grads_e)
    del grads_e, grads_g
    moe_parity(batch[:1])

    one_rank_group()
    os.environ["JAX_MESH_SPEC"] = '{"fsdp": 1}'
    try:
        sharded = train_run(build, peak, "k", [*MOE_ARGS, "--steps", "3"])
    finally:
        del os.environ["JAX_MESH_SPEC"]
        dist.destroy_process_group()
    check_losses("k", "one-rank FSDP2 (router in its own group) against unsharded",
                 sharded["losses"], main["losses"][:3])

    x = torch.randn(8, 2048, 768, device="cuda").to(torch.bfloat16)
    fwd, both = routing_ms(x, main["config"])
    per_step = main["config"].n_layers * (fwd + both)
    log(f"[k] dispatch + combine einsums of one layer at [8, 2048, 768], groups of 256, "
        f"cap 80: forward {fwd:.4f} ms, forward and backward {both:.4f} ms; a step runs "
        f"forward, replay and backward in each of 12 layers: {per_step:.3f} ms")

    results = phase_c(flash, rope_mod, peak, {"moe_125m": MOE_SHAPE}, main="moe_125m",
                      label="k")
    for name, res in results.items():
        res["name"] = f"{name}[moe-125m]"
        res["launches"] = main["launches"][name]
        res["launches_per_step"] = main["per_step"][name]
    return results, main["losses"]


# Phase (l): bert-base at full width and depth through the JAX bench's
# BERT path: make_train_step with train_step.loss_fn (no mask, so the
# non-causal flash kernels at head_dim 64; the chunked loss over the tied
# head with its bias) and AdamW from make_optimizer(warmup_steps=10,
# decay_steps=1000), bs 16, seq 512; 1 warm-up step and a window of 7.
BERT_BATCH, BERT_SEQ, BERT_STEPS = 16, 512, 8
BERT_LINE = re.compile(r"^\[bert\] step (\d+) loss (\S+) tokens/sec ([\d,]+)", re.M)


def phase_l(build, peak) -> dict:
    """BERT on the card: 2 layers of bert-base card against CPU, bert-base
    trained through the bench path (step time, tokens/s, MFU, peak memory,
    launches of the head_dim-64 kernels: 24 forward, 12 dQ and 12 dK/dV a
    step, the flash forward replayed under "dots"), and the bert_train
    entry point for 4 steps. Returns the training run's losses and
    launches, and its batches."""
    import numpy as np

    from tf_operator_tpu_torch.models import bert

    cfg = bert.CONFIGS["bert-base"]
    rng = np.random.default_rng(0)
    parity_tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, BERT_SEQ + 1))).long()
    card_cpu_parity("l", bert.Bert, dataclasses.replace(cfg, n_layers=2), parity_tokens)

    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ + 1),
                                             dtype=np.int32)).cuda() for _ in range(BERT_STEPS)]
    run = bert_window(build, peak, "l", batches)
    if abs(run["losses"][0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {run['losses'][0]} is far from ln(vocab)")

    bert_train_steps("l", [])
    run["batches"] = batches
    return run


def bert_train_steps(label: str, argv: list) -> None:
    """bert_train.main with ``argv`` for 4 steps at bs 16: it exits 0 and
    prints 4 finite losses."""
    import contextlib
    import io

    from tf_operator_tpu_torch.train import bert_train

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = bert_train.main([*argv, "--steps", "4", "--batch", str(BERT_BATCH),
                                "--log-every", "1"])
    text = out.getvalue()
    steps = {int(k): float(v) for k, v, _ in BERT_LINE.findall(text)}
    log(f"[{label}] bert_train.main {' '.join(argv)}: exit {code} in "
        f"{time.perf_counter() - t0:.1f} s; " + "; ".join(text.strip().splitlines()))
    if code != 0 or sorted(steps) != [0, 1, 2, 3] or not all(
            math.isfinite(x) for x in steps.values()):
        raise AssertionError(f"bert_train printed {text}")


def bert_window(build, peak, label: str, batches: list, replica_group=None,
                model_name: str = "bert-base") -> dict:
    """``model_name`` (bert-base by default) through the bench path on
    ``batches`` from seed 0's weights (data parallel over
    ``replica_group`` when given): 1 warm-up step and a window of the
    rest, with the launch counters and the peak device memory reset just
    before and read just after; launches a step flash_fwd_d64 two a layer
    (the forward replayed under "dots"), flash_dq_d64 and flash_dkv_d64
    one a layer (bert-base: 24/12/12) and no other. Returns losses,
    launches and times."""
    from tf_operator_tpu_torch.models import bert
    from tf_operator_tpu_torch.train.train_step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    cfg = bert.CONFIGS[model_name]
    gc.collect()
    torch.cuda.empty_cache()
    model = bert.Bert(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    optimizer = make_optimizer(warmup_steps=10, decay_steps=1000)
    state = init_train_state(model, optimizer)
    step_fn = make_train_step(optimizer, replica_group=replica_group)
    steps = len(batches)
    losses = torch.empty(steps, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i, batch in enumerate(batches):
        state, loss = step_fn(state, batch)
        losses[i].copy_(loss)
        if i == 0:
            losses[0].item()  # the warm-up step ends where the window starts
            t0 = time.perf_counter()
    losses = losses.tolist()  # waits for the last step
    window = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_s = window / (steps - 1)
    tokens_per_s = batches[0].shape[0] * BERT_SEQ / step_s
    mfu = tokens_per_s * cfg.flops_per_token(BERT_SEQ) / (peak.bf16_tflops * 1e12)
    per_step = {k: n / steps for k, n in launches.items()}
    log(f"[{label}] {model_name} ({cfg.param_count():,} parameters), bs {batches[0].shape[0]}, "
        f"seq {BERT_SEQ}, remat {cfg.remat_policy}: losses {losses}")
    log(f"[{label}] window of {steps - 1} steps in {window:.4f} s: step {step_s:.4f} s, "
        f"tokens/s {tokens_per_s:.1f}, MFU {mfu:.4f} (peak {peak.bf16_tflops} TFLOP/s, "
        f"{cfg.flops_per_token(BERT_SEQ):.4e} FLOP a token); peak device memory "
        f"{peak_gib:.3f} GiB")
    log(f"[{label}] launches in {steps} steps {launches}, per step {per_step}")
    want = {name: 0 for name in launches}
    want.update(flash_fwd_d64=2 * cfg.n_layers, flash_dq_d64=cfg.n_layers,
                flash_dkv_d64=cfg.n_layers)
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    del model, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": launches, "step_s": step_s, "per_step": per_step}


def one_rank_group():
    """A one-rank NCCL group in this process, on card 0."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))


def phase_m(build, peak, moe_losses: list, bert_run: dict) -> None:
    """The multi-card layer on one card, a one-rank NCCL group: moe-125m
    through the entry point under JAX_MESH_SPEC {"ep": 1} (the experts
    DTensors over ep, the dispatch and the combine through the
    all-to-all), phase k's 8 losses; bert-base's data-parallel step on the
    bench path (the gradients and the loss averaged over the group),
    phase l's losses."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import bert
    from tf_operator_tpu_torch.parallel import experts
    from tf_operator_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from tf_operator_tpu_torch.parallel.sharding import data_parallel_group

    one_rank_group()
    os.environ["JAX_MESH_SPEC"] = '{"ep": 1}'
    try:
        experts.reset_counts()
        moe = train_run(build, peak, "m", [*MOE_ARGS, "--steps", "8"])
        a2a = experts.COUNTS["all_to_all"]
        group, size = data_parallel_group(bert.CONFIGS["bert-base"],
                                          make_mesh(MeshSpec({"dp": 1}), "cuda"))
        dp = bert_window(build, peak, "m", bert_run["batches"], replica_group=group)
    finally:
        del os.environ["JAX_MESH_SPEC"]
        dist.destroy_process_group()
    cfg = moe["config"]
    want = len(moe["losses"]) * cfg.n_layers * 6  # forward, replay, backward: 2 each
    log(f"[m] moe-125m on mesh {moe['mesh']}: all-to-alls {a2a} in {len(moe['losses'])} steps "
        f"({a2a / len(moe['losses']):.0f} a step; {want} expected)")
    if moe["mesh"] != {"fsdp": 1, "ep": 1} or a2a != want:
        raise AssertionError(f"mesh {moe['mesh']}, {a2a} all-to-alls")
    check_losses("m", "expert axis ep=1 against phase k's einsum run", moe["losses"], moe_losses)
    log(f"[m] bert-base data parallel over a group of {size}")
    check_losses("m", "data-parallel bert-base against phase l", dp["losses"],
                 bert_run["losses"])


def phase_n() -> None:
    """scripts/multicard_smoke.py on every visible card, when there are 2
    or more."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[n] phase n did not run: {n} card visible, and the multi-card rows "
            "(scripts/multicard_smoke.py) need 2 or more")
        return
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "multicard_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=1500)
    for line in proc.stdout.splitlines()[-200:]:
        log(line)
    log(f"[n] scripts/multicard_smoke.py on {n} cards: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"phase n failed on {n} cards")


# Phase (o): ring attention's block path at llama-400m's width and a
# sequence of 8192 split over 4 sequence shards, the shape that
# scripts/multicard_smoke.py's sp=4 rows give each card.
RING = dict(b=2, s=8192, h=8, kvh=8, d=128, causal=True, sp=4)


def phase_o(build) -> None:
    """The ring's blocks (``ops/ring_attention.ring_blocks``: full,
    diagonal and skipped blocks, the lse combine, and the backward with
    dlse) with ``RING["sp"]`` virtual ring ranks run in turn in this
    process, each rank's K/V blocks taken from the others' shards in the
    order the rotations would bring them, through the kernels; held
    against one causal flash call over the whole sequence at phase c's
    tolerances. Each rank's launches (ring rank r: r + 1 of the forward,
    dQ and dK/dV) and its forward and backward's ms (CUDA events), whose
    spread is the ring's imbalance."""
    from tf_operator_tpu_torch.ops import ring_attention as ra
    from tf_operator_tpu_torch.ops.flash import flash_attention

    gc.collect()
    torch.cuda.empty_cache()
    c, n = RING, RING["sp"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do, _ = case_inputs(c, gen)
    ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = flash_attention(*ref_in, causal=True)
    ref.backward(do)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sl = c["s"] // n

    def shards(t):
        return [t[:, r * sl:(r + 1) * sl].contiguous() for r in range(n)]

    def ring(r, qp, kp, vp):
        return ra.ring_blocks(qp[r], r, n, lambda i: (kp[(r - i) % n], vp[(r - i) % n]))

    qp, kp, vp = (shards(t) for t in leaves)
    dop = shards(do)
    outs, launches = [], []
    for r in range(n):
        build.reset_launches()
        o = ring(r, qp, kp, vp)
        o.backward(dop[r])
        torch.cuda.synchronize()
        launches.append({name: build.LAUNCHES[name]
                         for name in ("flash_fwd", "flash_dq", "flash_dkv")})
        outs.append(o.detach())
    want = [{name: r + 1 for name in ("flash_fwd", "flash_dq", "flash_dkv")} for r in range(n)]
    log(f"[o] ring of {n} virtual ranks at {c['b']}x{c['s']}x{c['h']}x{c['d']} bf16 causal: "
        f"launches a rank {launches} (want r + 1 each: {want})")
    if launches != want:
        raise AssertionError(f"ring launches {launches}, want {want}")
    check("o", "ring", torch.cat(outs, 1), ref, TOL["o"], "o")
    for name, got, r in zip(("dq", "dk", "dv"), leaves, ref_in):
        check(name, "ring", got.grad, r.grad, TOL[name], "o")
    # Each ring rank's forward and backward alone, on fresh leaves.
    qp, kp, vp = ([t.detach().requires_grad_() for t in shards(x)] for x in (q, k, v))
    rank_ms = [time_ms(lambda r=r: torch.autograd.grad(ring(r, qp, kp, vp), (qp[r], *kp, *vp),
                                                       dop[r]), iters=5, warmup=1)
               for r in range(n)]
    whole = [t.detach().requires_grad_() for t in (q, k, v)]
    whole_ms = time_ms(lambda: torch.autograd.grad(flash_attention(*whole, causal=True),
                                                   whole, do), iters=5, warmup=1)
    mean = sum(rank_ms) / n
    log(f"[o] forward + backward ms a ring rank {[round(t, 4) for t in rank_ms]}: slowest "
        f"{max(rank_ms) / mean:.3f}x the mean (the slowest rank sets a ring's step); "
        f"their sum {sum(rank_ms):.4f} ms against one causal flash call over the whole "
        f"sequence {whole_ms:.4f} ms ({sum(rank_ms) / whole_ms:.3f}x)")


# Phase (p): ResNet and MNIST, the JAX package's last two model families.
# ResNet-50 card (bf16, channels_last) against CPU (fp32) at bs 2, 224x224,
# one training step's forward and backward, from the port's seeded init
# with each block's last BatchNorm scale at 0.1 (its init's 0 would zero
# the gradient of every layer of the block's branch). The loss and each
# convolution's and the head's gradient norm at PARITY_TOL. A BatchNorm's
# scale and bias gradients are sums over the batch of a gradient whose
# per-channel mean the next BatchNorm's backward removed: their norms are
# small differences of large sums, and bf16's rounding of the incoming
# gradient (2^-8) shows there at up to 0.11 (the same step in bf16 on the
# CPU against fp32), so RESNET_TOL holds them at 0.25, the whole gradient
# at 0.2 relative in L2 (0.084 there), and each BatchNorm's batch mean and
# variance (read back from the running update) at 2e-2 (0.009 there).
RESNET = dict(model="resnet50", image=224, batch=256, warmup=2, steps=7)
RESNET_TOL = {"norm_grad": 0.25, "grad": 0.2, "stats": 2e-2}
MNIST_ARGS = ["--steps=600", "--batch=256", "--target-accuracy=0.95"]  # jaxjob_mnist.yaml


def resnet_parity(name: str = RESNET["model"], label: str = "p") -> None:
    """``name`` (resnet50 by default) from the port's seed-0 init (each
    block's last BatchNorm scale at 0.1): one training-mode forward and
    backward at bs 2 on the card (bf16, channels_last) and on the CPU
    (fp32), within PARITY_TOL and RESNET_TOL."""
    import numpy as np
    import torch.nn.functional as F

    from tf_operator_tpu_torch.models import resnet

    cfg = resnet.CONFIGS[name]
    cpu_model = resnet.ResNet(dataclasses.replace(cfg, dtype=torch.float32), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    norms = {n for n, m in cpu_model.named_modules() if isinstance(m, resnet.BatchNorm)}
    with torch.no_grad():
        for n in norms:
            m = cpu_model.get_submodule(n)
            if m.zero_scale:
                m.weight.fill_(0.1)
    start = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    gpu_model = resnet.ResNet(cfg, device="cuda")
    gpu_model.load_state_dict(start)
    rng = np.random.default_rng(0)
    size = RESNET["image"]
    images = torch.from_numpy(rng.normal(0, 1, (2, size, size, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, (2,))).long()

    t0 = time.perf_counter()
    gpu_loss = F.cross_entropy(gpu_model(images.cuda()), labels.cuda())
    gpu_loss.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_loss = F.cross_entropy(cpu_model(images), labels)
    cpu_loss.backward()
    t2 = time.perf_counter()
    loss_rel = rel(gpu_loss.item(), cpu_loss.item())
    cpu_params = dict(cpu_model.named_parameters())
    grads = {n: rel(p.grad.float().norm().item(), cpu_params[n].grad.norm().item())
             for n, p in gpu_model.named_parameters()}
    whole = [torch.cat([p.grad.float().flatten().cpu() for p in m.parameters()])
             for m in (gpu_model, cpu_model)]
    whole_rel = ((whole[0] - whole[1]).norm() / whole[1].norm()).item()
    cpu_buffers = dict(cpu_model.named_buffers())
    stats = {}
    for n, b in gpu_model.named_buffers():  # the batch's mean and variance
        got, want = ((x.float().cpu() - 0.9 * start[n]) / 0.1 for x in (b, cpu_buffers[n]))
        stats[n] = ((got - want).norm() / want.norm()).item()
    in_norm = {n: n.rsplit(".", 1)[0] in norms for n in grads}
    worst_conv = max((n for n in grads if not in_norm[n]), key=grads.get)
    worst_norm = max((n for n in grads if in_norm[n]), key=grads.get)
    worst_stat = max(stats, key=stats.get)
    log(f"[{label}] {name} ({sum(p.numel() for p in cpu_params.values()):,} parameters) "
        f"bs 2 at {size}x{size}, one training step: loss card {gpu_loss.item():.6f} cpu "
        f"{cpu_loss.item():.6f}, rel {loss_rel:.3e} (tol {PARITY_TOL['loss']}; card "
        f"{t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
    log(f"[{label}] worst grad-norm rel of a convolution or the head {grads[worst_conv]:.3e} at "
        f"{worst_conv} (tol {PARITY_TOL['grad_norm']}), of a BatchNorm "
        f"{grads[worst_norm]:.3e} at {worst_norm} (tol {RESNET_TOL['norm_grad']}), over "
        f"{len(grads)} parameters; the whole gradient rel L2 {whole_rel:.3e} (tol "
        f"{RESNET_TOL['grad']}); worst batch-statistics rel L2 {stats[worst_stat]:.3e} at "
        f"{worst_stat} over {len(stats)} buffers (tol {RESNET_TOL['stats']})")
    if not (loss_rel <= PARITY_TOL["loss"] and grads[worst_conv] <= PARITY_TOL["grad_norm"]
            and grads[worst_norm] <= RESNET_TOL["norm_grad"] and whole_rel <= RESNET_TOL["grad"]
            and stats[worst_stat] <= RESNET_TOL["stats"]):
        raise AssertionError(f"{name} card against CPU: outside the tolerances above")
    del gpu_model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()


def phase_p(peak) -> None:
    """ResNet-50 card against CPU; resnet_train at resnet50, 224x224,
    global batch 256 on this card (a 2-step warm-up run, then a run whose
    window holds its steps after the first): step time, images/s, MFU
    (3 x the forward FLOPs of the convolutions and the head a image) and
    peak memory, the host's draw of one batch and the same step on a
    batch resident on the card; mnist_train with the manifest's
    arguments reaches its target. (The step under torch.compile, a
    yardstick that took 233 s to compile, is no longer run here, to keep
    the run within its time; PERF.md keeps its last reading.)"""
    import contextlib
    import io

    from tf_operator_tpu_torch.models import resnet
    from tf_operator_tpu_torch.train import data, mnist_train, resnet_train

    resnet_parity()
    argv = ["--model", RESNET["model"], "--image-size", str(RESNET["image"]), "--batch",
            str(RESNET["batch"]), "--log-every", "100"]
    cfg = resnet.CONFIGS[RESNET["model"]]
    flops = 3 * cfg.forward_flops(RESNET["image"])
    with contextlib.redirect_stdout(io.StringIO()):
        resnet_train.run(resnet_train.parse_args([*argv, "--steps", str(RESNET["warmup"])]))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = resnet_train.run(resnet_train.parse_args([*argv, "--steps", str(RESNET["steps"])]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = out["window_seconds"] / out["window_steps"]
    ips = out["images_per_step"] / step_s
    mfu = ips * flops / (peak.bf16_tflops * 1e12)
    log(f"[p] resnet_train {RESNET['model']} {RESNET['image']}x{RESNET['image']} global batch "
        f"{RESNET['batch']}, one card: losses {out['losses']}; window of {out['window_steps']} "
        f"steps in {out['window_seconds']:.4f} s (after {RESNET['warmup']} warm-up steps and "
        f"the run's first): step {step_s:.4f} s, images/s {ips:.1f}, MFU {mfu:.4f} "
        f"({flops:.4e} FLOP an image, peak {peak.bf16_tflops} TFLOP/s); peak device memory "
        f"{peak_gb:.3f} GB")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss {out['losses']}")

    # Where the window's time goes: the host's draw of one batch, and the
    # step alone on a batch already on the card.
    draws = resnet_train.batches(0, RESNET["batch"], RESNET["image"], cfg.num_classes)
    t0 = time.perf_counter()
    host = next(draws)
    draw_s = time.perf_counter() - t0
    images, labels = data.to_device(*host, torch.device("cuda"))
    model = out["model"]
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    step_fn = resnet_train.make_train_step(model, optimizer)
    resident_ms = time_ms(lambda: step_fn(images, labels), iters=5, warmup=2, repeats=1)
    resident_ips = RESNET["batch"] / (resident_ms / 1e3)
    log(f"[p] the host draws one batch in {draw_s:.4f} s (numpy, the JAX script's draw); the "
        f"step on a resident batch {resident_ms:.2f} ms (CUDA events over 5 steps): images/s "
        f"{resident_ips:.1f}, MFU {resident_ips * flops / (peak.bf16_tflops * 1e12):.4f}")
    del out, model, optimizer, step_fn, images, labels
    gc.collect()
    torch.cuda.empty_cache()

    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        code = mnist_train.main(MNIST_ARGS)
    lines = text.getvalue().strip().splitlines()
    log(f"[p] mnist_train {' '.join(MNIST_ARGS)}: exit {code} in "
        f"{time.perf_counter() - t0:.1f} s; " + "; ".join(lines[-3:]))
    if code != 0:
        raise AssertionError("mnist_train missed its target accuracy")


STEP_LINE = re.compile(r"^\[llama\] step (\d+) loss (\S+) tokens/sec ([\d,]+)", re.M)


def read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def phase_j(steps: int = 32, timeout: float = 600.0) -> None:
    """The flagship as a pod runs it: SIGKILLed at the durable edge while it
    still trains, started again, resumed via storage; its heartbeat and its
    profiler trace. ``steps`` is enough that the first persist is durable
    before the loop ends: each save blocks the loop for its snapshot only."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = seeded_tokens(tmp)
        beat, prof = os.path.join(tmp, "beat.json"), os.path.join(tmp, "profile")
        argv = [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", *MAIN_ARGS,
                "--log-every", "1", "--steps", str(steps), "--checkpoint-every", "3",
                "--checkpoint-dir", os.path.join(tmp, "ckpt"), "--data", path,
                "--data-dtype", "uint16"]
        env = {**os.environ, "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0",
               "TPU_HEARTBEAT_LEASE": "smoke-worker-0-hb", "TPU_HEARTBEAT_FILE": beat,
               "TPU_HEARTBEAT_INTERVAL_SECONDS": "1", "TPU_DELTA_PERSIST": "1",
               "TPU_PROFILE_DIR": prof, "TPU_PROFILE_START_STEP": "1",
               "TPU_PROFILE_NUM_STEPS": "2"}

        def traces():
            return sorted(glob.glob(os.path.join(prof, "*.pt.trace.json")))

        t0 = time.perf_counter()
        with open(os.path.join(tmp, "first.log"), "w") as out:
            first = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                     stderr=subprocess.STDOUT, text=True)
            try:
                durable = None
                while first.poll() is None and time.perf_counter() - t0 < timeout:
                    durable = (read_json(beat) or {}).get("checkpoint_step")
                    if durable is not None and traces():
                        break
                    time.sleep(0.01)
                first.send_signal(signal.SIGKILL)
                first.wait(60)
            finally:
                if first.poll() is None:
                    first.kill()
        killed_at = time.perf_counter() - t0
        with open(os.path.join(tmp, "first.log")) as f:
            first_log = f.read()
        lines = STEP_LINE.findall(first_log)
        before = {int(k): float(loss) for k, loss, _ in lines}
        # Step k's line carries (k + 1) steps' tokens over the seconds since
        # the loop began: the seconds to each step's end, the window's
        # closing step (3, which writes the trace) included.
        ends = {int(k): round((int(k) + 1) * 8 * 2048 / float(tps.replace(",", "")), 3)
                for k, _, tps in lines}
        log(f"[j] first run: SIGKILLed {killed_at:.1f} s after its start, once the heartbeat "
            f"file showed checkpoint_step {durable}; it had printed steps {sorted(before)}; "
            f"exit {first.returncode}; seconds from the loop's start to each step's end {ends}")
        if first.returncode != -signal.SIGKILL or durable is None or max(before) >= steps - 1:
            raise AssertionError(f"the first run was not killed at a durable step while it "
                                 f"trained (exit {first.returncode}, checkpoint_step {durable}, "
                                 f"last step printed {max(before)}):\n{first_log[-3000:]}")
        t1 = time.perf_counter()
        second = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                                timeout=timeout)
        log(f"[j] second run: exit {second.returncode} in {time.perf_counter() - t1:.1f} s")
        if second.returncode != 0:
            raise AssertionError(f"the second run failed:\n{second.stdout[-3000:]}"
                                 f"{second.stderr[-3000:]}")
        resumed = re.search(r"\[llama\] resumed from step (\d+) via storage \(ok\)",
                            second.stdout)
        log(f"[j] {resumed[0] if resumed else 'no resume line'}")
        if not resumed or not durable <= int(resumed[1]) <= max(before) + 1:
            raise AssertionError(f"the second run did not resume from storage at or after "
                                 f"step {durable}:\n{second.stdout[-3000:]}")
        after = {int(k): float(loss) for k, loss, _ in STEP_LINE.findall(second.stdout)}
        both = sorted(set(before) & set(after))
        if sorted(after) != list(range(int(resumed[1]), steps)) or not both:
            raise AssertionError(f"steps {sorted(after)} after a resume from {resumed[1]}; "
                                 f"both runs printed {both}")
        check_losses("j", f"second run against the first on steps {both}",
                     [after[k] for k in both], [before[k] for k in both])
        final = read_json(beat) or {}
        log(f"[j] heartbeat file at the end: {final}")
        if (final.get("step") != steps - 1 or not final.get("tokens_per_sec")
                or final.get("checkpoint_step") != steps
                or not str(final.get("restore", "")).startswith("storage:ok:")):
            raise AssertionError(f"the heartbeat file ended on {final}")
        (trace,) = traces()
        events = read_json(trace)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        seen = {name: sum(sym in k for k in kernels) for name, sym in KERNEL_SYMBOLS.items()}
        log(f"[j] trace {os.path.basename(trace)} ({os.path.getsize(trace)} bytes, "
            f"{len(events)} events, {len(kernels)} CUDA kernel events); launches of the "
            f"hand-written kernels in it {seen}")
        if not all(seen.values()):
            raise AssertionError(f"the trace misses a hand-written kernel: {seen}")


def node_env(nodes: int, node: int, gpus: int, port: int, mesh: dict = None) -> dict:
    """The env the operator gives pod ``node`` of a JAXJob that
    ``tf_operator_tpu_torch.api.gpu.gpu_job`` renders for ``nodes`` nodes
    of ``gpus`` cards (``numSlices`` = nodes, its default mesh unless
    ``mesh`` is given), written out here with every service host on this
    machine's loopback and the coordinator on ``port``: the JAXJob contract
    of one process a node, which the per-node launcher turns into one
    process a card."""
    if mesh is None:
        mesh = {"slice": nodes, "fsdp": gpus} if nodes > 1 else {"fsdp": gpus}
    env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": str(nodes),
           "JAX_PROCESS_ID": str(node), "TPU_WORKER_ID": "0",
           "TPU_WORKER_HOSTNAMES": "127.0.0.1", "JAX_NUM_SLICES": str(nodes),
           "JAX_SLICE_INDEX": str(node),
           "JAX_MESH_SPEC": json.dumps(mesh, separators=(",", ":"))}
    if nodes > 1:
        env.update(MEGASCALE_COORDINATOR_ADDRESS="127.0.0.1", MEGASCALE_NUM_SLICES=str(nodes),
                   MEGASCALE_SLICE_ID=str(node))
    return env


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_argv(gpus: int, command: list) -> list:
    """``command`` under the per-node launcher, ``gpus`` processes."""
    return [sys.executable, "-m", "tf_operator_tpu_torch.runtime.launch", "--nproc-per-node",
            str(gpus), "--", *command]


DONE_LINE = re.compile(r"^\[llama\] done (\{.*\})$", re.M)


def done_lines(text: str) -> dict:
    """{process: the ``[llama] done`` summary} of every rank in ``text``."""
    return {s["process"]: s for s in map(json.loads, DONE_LINE.findall(text))}


def phase_q(main: dict, timeout: float = 600.0) -> None:
    """The per-node launcher on one card: ``launch --nproc-per-node 1 --
    llama_train`` under the env of a 1-node JAXJob of one card, phase e's
    arguments; its losses phase e's (LOSS_TOL) at phase e's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    env = {**os.environ, **node_env(1, 0, 1, free_port())}
    t0 = time.perf_counter()
    command = [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", *MAIN_ARGS,
               "--steps", "4"]
    proc = subprocess.run(launch_argv(1, command), cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("[gpu_init]", "[llama] process")):
            log(f"[q] {line}")
    log(f"[q] launcher exit {proc.returncode} in {seconds:.1f} s")
    runs = done_lines(proc.stdout)
    if proc.returncode != 0 or list(runs) != [0]:
        raise AssertionError(f"the launched run failed (exit {proc.returncode}, summaries of "
                             f"processes {list(runs)}):\n{proc.stdout[-3000:]}"
                             f"{proc.stderr[-3000:]}")
    run = runs[0]
    check_losses("q", "through the launcher against phase e", run["losses"], main["losses"])
    per_step = {k: run["launches"].get(k, 0) / len(run["losses"]) for k in KERNEL_SYMBOLS}
    want = {k: main["per_step"][k] for k in KERNEL_SYMBOLS}
    step_s = run["window_seconds"] / max(run["window_steps"], 1)
    log(f"[q] launches a step {per_step} (phase e: {want}); step {step_s:.4f} s, tokens/s "
        f"{run['tokens_per_step'] / step_s:.1f} (phase e: {main['tokens_per_s']:.1f}); peak "
        f"{run['peak_bytes'] / 2**30:.3f} GiB (phase e: {main['peak_gib']:.3f})")
    if per_step != want:
        raise AssertionError(f"launches a step {per_step} through the launcher, phase e {want}")


# Phase (r): the recovery plane on one card. Two slice-local worlds of one
# card each share it, a checkpoint every RECOVERY_EVERY steps: a persist
# of llama-400m's 2.24 GB state takes 5.0-5.2 s (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6), so a save every 3 steps (0.6 s) would queue
# snapshots, 2.24 GB of pinned host memory each, faster than the persists
# drain them. RECOVERY_STEPS is enough that slice 0 still trains when
# slice 1 has restarted.
RECOVERY_STEPS = 180
RECOVERY_EVERY = 20


def slice_env(slice_index: int, port: int, beat: str, peers: str = "", gpus: int = 1) -> dict:
    """The env of the pod of slice ``slice_index`` of a 2-node, 2-slice
    JAXJob of ``gpus`` cards a node (:func:`node_env`, the mesh of one
    slice) whose template sets JAX_SLICE_LOCAL_WORLD, with the operator's
    peer restore on (TPU_SHARD_SERVER; TPU_PEER_RESTORE_ADDRS on a rebuilt
    pod) and the heartbeat file the process backend gives a pod."""
    env = {**os.environ, **node_env(2, slice_index, gpus, port, mesh={"fsdp": gpus}),
           "JAX_SLICE_LOCAL_WORLD": "1", "TPU_SHARD_SERVER": "1",
           "TPU_HEARTBEAT_LEASE": f"recovery-worker-{slice_index}-hb",
           "TPU_HEARTBEAT_FILE": beat, "TPU_HEARTBEAT_INTERVAL_SECONDS": "1"}
    if peers:
        env["TPU_PEER_RESTORE_ADDRS"] = peers
    return env


def published_peer(beat: str, proc, timeout: float) -> dict:
    """The heartbeat file ``beat`` once it carries the shard server's
    address (a survivor publishes it after its restore), while ``proc``
    runs; ``{}`` when it never does."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        survivor = read_json(beat) or {}
        if survivor.get("peer_addr"):
            return survivor
        time.sleep(0.05)
    return {}


def watch_manifests(directory: str, seen: dict, stop: threading.Event) -> None:
    """Keep ``{step: {shard: checksum}}`` of every manifest that appears
    in ``directory`` (the store's retention deletes old ones)."""
    while not stop.is_set():
        try:
            names = os.listdir(directory)
        except OSError:
            names = []
        for name in names:
            m = re.fullmatch(r"manifest-(\d+)\.json", name)
            if m and int(m[1]) not in seen:
                manifest = read_json(os.path.join(directory, name))
                if manifest:
                    seen[int(m[1])] = {n: e["checksum"] for n, e in manifest["shards"].items()}
        stop.wait(0.05)


def phase_r(main: dict, timeout: float = 900.0) -> None:
    """The recovery plane of a 2-slice GPU job on one card: two launchers
    (``--nproc-per-node 1``) of slice-local worlds train llama-400m with
    phase e's arguments from phase g's seeded token file; slice 1 is
    SIGKILLed as a process group, as the operator's process backend
    deletes a pod (its launcher and its child together; the child would
    also die with the launcher alone, by its parent-death signal), after
    its first durable checkpoint, and started again with slice 0's published address. It
    must resume through a peer rung with the bytes slice 0 persisted at
    that step (the digest of the checksums it verified against the one of
    slice 0's manifest), at slice 0's losses and phase e's launches; slice
    0 runs on undisturbed, its process the same. Then the recovery legs
    of ``scripts/measure_recovery_torch.py`` at llama-400m's state."""
    from tf_operator_tpu_torch.train.restore import checksum_digest

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = seeded_tokens(tmp)
        root, port = os.path.join(tmp, "ckpt"), free_port()
        beats = [os.path.join(tmp, f"beat{s}.json") for s in range(2)]
        command = launch_argv(1, [
            sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", *MAIN_ARGS,
            "--steps", str(RECOVERY_STEPS), "--checkpoint-every", str(RECOVERY_EVERY),
            "--checkpoint-dir", root, "--data", path, "--data-dtype", "uint16"])
        logs = {}

        def start(slice_index: int, tag: str, peers: str = ""):
            logs[tag] = os.path.join(tmp, f"{tag}.log")
            with open(logs[tag], "w") as out:
                return subprocess.Popen(command, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                        env=slice_env(slice_index, port, beats[slice_index], peers),
                                        start_new_session=True)

        seen, stop = {}, threading.Event()
        watcher = threading.Thread(target=watch_manifests, daemon=True,
                                   args=(os.path.join(root, "slice-0", "delta"), seen, stop))
        watcher.start()
        procs = []
        t0 = time.perf_counter()
        try:
            procs += [start(0, "slice0"), start(1, "slice1")]
            first_pid = procs[0].pid
            durable = None
            while time.perf_counter() - t0 < timeout:
                durable = (read_json(beats[1]) or {}).get("checkpoint_step")
                if durable is not None or procs[1].poll() is not None:
                    break
                time.sleep(0.05)
            os.killpg(procs[1].pid, signal.SIGKILL)
            procs[1].wait(60)
            killed = time.perf_counter() - t0
            survivor = published_peer(beats[0], procs[0], 60.0)
            log(f"[r] slice 1 SIGKILLed (its process group) {killed:.1f} s after the start, at "
                f"its durable checkpoint_step {durable}; slice 0 at step "
                f"{survivor.get('step')}, durable {survivor.get('checkpoint_step')}, serving at "
                f"{survivor.get('peer_addr')}")
            if durable is None or procs[0].poll() is not None or not survivor.get("peer_addr"):
                raise AssertionError(f"slice 1 made no durable checkpoint while slice 0 "
                                     f"trained and served: {survivor}")
            t1 = time.perf_counter()
            procs.append(start(1, "slice1-restarted", survivor["peer_addr"]))
            for p in (procs[0], procs[2]):
                p.wait(max(timeout - (time.perf_counter() - t0), 1.0))
            log(f"[r] slice 1 restarted in {time.perf_counter() - t1:.1f} s to its end; slice 0 "
                f"(pid {procs[0].pid}, first {first_pid}) exited {procs[0].returncode}, the "
                f"restarted slice 1 {procs[2].returncode}")
        finally:
            stop.set()
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        texts = {tag: open(p).read() for tag, p in logs.items()}
        runs = {tag: done_lines(text).get(0) for tag, text in texts.items()}
        for tag, text in texts.items():
            for line in text.splitlines():
                if line.startswith(("[gpu_init]", "[llama] process", "[llama] resumed")):
                    log(f"[r] {tag}| {line}")
        for tag in ("slice0", "slice1-restarted"):
            if runs[tag]:
                log(f"[r] {tag}: restore {runs[tag]['restore']}; last persist "
                    f"{runs[tag]['persist']}")
        if (procs[0].pid != first_pid or procs[0].returncode != 0 or procs[2].returncode != 0
                or not runs["slice0"] or not runs["slice1-restarted"]):
            raise AssertionError(
                f"slice 0 exited {procs[0].returncode}, the restarted slice 1 "
                f"{procs[2].returncode}:\n{texts['slice0'][-3000:]}"
                f"{texts['slice1-restarted'][-3000:]}")
        zero, one = runs["slice0"], runs["slice1-restarted"]
        restore, k = one["restore"], one["start_step"]
        want = checksum_digest(seen[k]) if k in seen else None
        log(f"[r] slice 1 resumed at step {k} via {restore['path']} ({restore['cause']}), "
            f"{restore['bytes_moved']} bytes in {restore['seconds']:.3f} s; digest "
            f"{restore['digest']}, slice 0's manifest of step {k}: {want}")
        if (restore["path"] not in ("peer", "peer-sharded") or restore["cause"] != "ok"
                or want is None or restore["digest"] != want):
            raise AssertionError(f"slice 1 did not resume through a peer with slice 0's bytes "
                                 f"of step {k}: {restore}, manifests seen {sorted(seen)}")
        check_losses("r", f"slice 1 from step {k} against slice 0", one["losses"],
                     zero["losses"][k:])
        per_step = {n: one["launches"].get(n, 0) / len(one["losses"]) for n in KERNEL_SYMBOLS}
        expect = {n: main["per_step"][n] for n in KERNEL_SYMBOLS}
        log(f"[r] restarted slice 1: {len(one['losses'])} steps, launches a step {per_step} "
            f"(phase e: {expect}); peak {one['peak_bytes'] / 2**30:.3f} GiB")
        if per_step != expect:
            raise AssertionError(f"launches a step {per_step}, phase e {expect}")
        for tag, run in (("slice 0", zero), ("slice 1 restarted", one)):
            for line in run["telemetry"].splitlines():
                if not line.startswith("#") and "_bucket{" not in line:
                    log(f"[r] {tag} telemetry| {line}")
    recovery_legs()


# Phase (s): the last layouts of the JAX package on one card, their new
# parts at full width, held against the whole form in the same process.
# moe-125m's MoE layer at the 4-card row's [4, 8192] (each of SP_RANKS
# virtual sp ranks [4, 2048]) and llama-400m's loss at [8, 2048] x 32000
# over VOCAB_SHARDS virtual tp shards. Both forms compute the same numbers
# in bf16; only the shapes of the products and the order of the sums
# differ, so the outputs and gradients are held at phase c's output
# tolerance relative to their largest element, and the fp32 aux loss and
# loss at LOSS_TOL.
SP_LAYER = dict(b=4, s=8192)
SP_RANKS = 4
# The layer's capacity factor there: at 0.5 both groupings drop routes
# (the phase fails where one does not). Where every route is kept, the
# slot a rank's routes start from cannot change the output, and a wrong
# offset across the ranks would pass unseen.
SP_CAPACITY = 0.5
VOCAB_LOSS = dict(b=8, s=2048)
VOCAB_SHARDS = 2
LAYOUT_TOL = 2e-2


def phase_s() -> None:
    """MoE over sp and the vocab-parallel loss on one card. The MoE layer
    of moe-125m at capacity factor ``SP_CAPACITY`` (routes must drop in
    both cases), as configured (routing groups of 256, inside each rank's
    piece) and with ``moe_group_size=0`` (one group of 8192 positions over
    the 4 ranks, whose slots start after the route counts of the ranks
    before: ``testing/virtual_ranks.moe_over_sp``) against the layer over
    the whole sequence: its output, aux loss and the gradients of
    ``sum(y * dy) + aux`` in x, the router and the experts; the
    vocab-parallel chunked loss (``StackedShards``: the two shards' rows of
    the head, their max and sums of exponentials reduced between them)
    against the unsharded chunked loss: the loss and its gradients in the
    hidden state and the head. Each part's max errors and the ms of one
    forward and backward of each form (each virtual rank's alone)."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.ops import cross_entropy
    from tf_operator_tpu_torch.testing.virtual_ranks import moe_over_sp

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s = SP_LAYER["b"], SP_LAYER["s"]
    for group in (llama.CONFIGS["moe-125m"].moe_group_size, 0):
        cfg = dataclasses.replace(llama.CONFIGS["moe-125m"], max_seq_len=s,
                                  moe_group_size=group, capacity_factor=SP_CAPACITY)
        moe = llama.MoE(cfg, device="cuda")
        with torch.no_grad():
            for p in moe.parameters():
                p.normal_(0.0, 0.02, generator=gen)
        x = torch.randn(b, s, cfg.dim, device="cuda", generator=gen).to(cfg.dtype)
        dy = torch.randn(b, s, cfg.dim, device="cuda", generator=gen).to(cfg.dtype)
        params = list(moe.parameters())

        def grads(layer, x=x, dy=dy, params=params):
            leaf = x.detach().requires_grad_()
            y, aux = layer(leaf)
            return (y.detach(), aux.detach(), *torch.autograd.grad(
                (y.float() * dy.float()).sum() + aux, [leaf, *params]))

        whole = grads(moe)
        slots, experts = [], moe._experts
        moe._experts = lambda h, experts=experts: slots.append(h.shape[2]) or experts(h)
        try:
            virtual = grads(lambda t, moe=moe: moe_over_sp(moe, t, SP_RANKS))
        finally:
            del moe._experts
        length, span = llama.routing_groups(cfg, s // SP_RANKS, SP_RANKS)
        what = (f"moe-125m MoE layer [{b}, {s}] capacity factor {SP_CAPACITY}, groups of "
                f"{length} (span {span} ranks)")
        routing = moe.route(x)
        kept = sum(int(((oh.cumsum(1) - oh + off[:, None]) < routing.cap)[oh > 0].sum())
                   for oh, off in zip(routing.onehot.unbind(2), llama.slot_offsets(
                       routing.counts()[None], 0, 1)))
        routes = int(routing.onehot.sum())
        log(f"[s] {what}: capacity {routing.cap}, routes kept {kept} of {routes}; each sp "
            f"rank's experts ran on {slots} slots")
        if kept >= routes:
            raise AssertionError(f"{what}: no route dropped, so the ranks' slot offsets "
                                 "go unchecked")
        names = ["y", "aux", "dx"] + [n for n, _ in moe.named_parameters()]
        for name, got, ref in zip(names, virtual, whole):
            if name == "aux":
                err = abs(got.item() - ref.item())
                ok = rel(got.item(), ref.item()) <= LOSS_TOL
                log(f"[s] {what} over {SP_RANKS} sp ranks: aux {got.item():.6f} against "
                    f"{ref.item():.6f}, max_abs_err {err:.3e} (tol {LOSS_TOL} rel) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{what}: aux loss over sp {got} against {ref}")
            else:
                check(name, f"sp{SP_RANKS}/g{length}", got, ref, LAYOUT_TOL, "s")
        whole_ms = time_ms(lambda: grads(moe), iters=3, warmup=1)
        pieces = [p.contiguous() for p in x.chunk(SP_RANKS, 1)]
        rank_ms = []
        for r in range(SP_RANKS):
            layout = moe.layout
            moe.layout = dataclasses.replace(layout, sp_rank=r, sp_size=SP_RANKS)
            try:
                # One rank's own forward and backward: its counts as the
                # exchange would give them, read once beforehand.
                counts = torch.stack([moe.route(p).counts() for p in pieces])

                def one_rank(r=r, counts=counts):
                    routing = moe.route(pieces[r].requires_grad_())
                    y = moe.assign(routing, llama.slot_offsets(counts, r, span))
                    f, p = routing.stats()
                    aux = moe.aux_loss(f, p, routing.tokens * SP_RANKS)
                    return torch.autograd.grad((y.float() * dy.chunk(SP_RANKS, 1)[r].float())
                                               .sum() + aux, [pieces[r], *params])

                rank_ms.append(time_ms(one_rank, iters=3, warmup=1))
            finally:
                moe.layout = layout
        log(f"[s] {what}: forward + backward ms, whole layer {whole_ms:.4f}, each sp rank "
            f"{[round(t, 4) for t in rank_ms]} (sum {sum(rank_ms):.4f})")
        del moe, whole, virtual, x, dy, params, pieces
        gc.collect()
        torch.cuda.empty_cache()

    cfg = llama.CONFIGS["llama-400m"]
    b, s = VOCAB_LOSS["b"], VOCAB_LOSS["s"]
    hidden = torch.randn(b, s, cfg.dim, device="cuda", generator=gen).to(cfg.dtype)
    head = (0.02 * torch.randn(cfg.vocab_size, cfg.dim, device="cuda", generator=gen)
            ).to(cfg.dtype)
    targets = torch.randint(0, cfg.vocab_size, (b, s), device="cuda", generator=gen)
    targets[:, -1] = -1  # a padded stream's last position: ignored

    def loss_grads(fn, weight):
        h, w = hidden.detach().requires_grad_(), weight.detach().requires_grad_()
        value = fn(h, w)
        return (value.detach(), *torch.autograd.grad(value, [h, w]))

    def whole_loss(h, w):
        return cross_entropy.chunked_cross_entropy(h, w, targets)

    def split_loss(h, w):
        return cross_entropy.vocab_parallel_cross_entropy(
            h, w, targets, cross_entropy.StackedShards(VOCAB_SHARDS))

    shards = head.view(VOCAB_SHARDS, -1, cfg.dim)
    ref = loss_grads(whole_loss, head)
    got = loss_grads(split_loss, shards)
    what = f"llama-400m loss [{b}, {s}] x {cfg.vocab_size} over {VOCAB_SHARDS} tp shards"
    ok = rel(got[0].item(), ref[0].item()) <= LOSS_TOL
    log(f"[s] {what}: loss {got[0].item():.6f} against {ref[0].item():.6f}, max_abs_err "
        f"{abs(got[0].item() - ref[0].item()):.3e} (tol {LOSS_TOL} rel) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: loss {got[0]} against {ref[0]}")
    check("dh", f"tp{VOCAB_SHARDS}", got[1], ref[1], LAYOUT_TOL, "s")
    check("dw", f"tp{VOCAB_SHARDS}", got[2].view_as(head), ref[2], LAYOUT_TOL, "s")
    whole_ms = time_ms(lambda: loss_grads(whole_loss, head), iters=3, warmup=1)
    split_ms = time_ms(lambda: loss_grads(split_loss, shards), iters=3, warmup=1)
    log(f"[s] {what}: forward + backward ms, unsharded {whole_ms:.4f}, both shards stacked "
        f"{split_ms:.4f}; phase s took {time.perf_counter() - t0:.1f} s")


# Phase (t): an elastic job on one card. ELASTIC_EVERY is phase r's
# cadence (a persist of llama-400m's state takes about 5 s); ELASTIC_STEPS
# is enough that the first durable step comes while the world still trains.
ELASTIC_STEPS = 60
ELASTIC_EVERY = 20
DELETE_GRACE = 2.0  # the process backend's SIGTERM grace before its SIGKILL


def elastic_env(port: int, beat: str) -> dict:
    """The env of the pod of an elastic ``gpu_job`` of llama-400m on one
    node of one card, ``elastic=(1, 2)``, as the operator renders it at one
    node (:func:`node_env`): at its start, and again after ``scale()`` to 2
    nodes and back to 1 (``tests/test_torch_elastic.py`` pins both), with
    the heartbeat file the process backend gives a pod whose job sets a
    progress deadline."""
    return {**os.environ, **node_env(1, 0, 1, port), "TPU_HEARTBEAT_LEASE": "elastic-worker-0-hb",
            "TPU_HEARTBEAT_FILE": beat, "TPU_HEARTBEAT_INTERVAL_SECONDS": "1"}


def delete_pods(procs: list) -> float:
    """What the operator's process backend does to the pods of a stale
    world, deleted in one batch: SIGTERM to each pod's process group,
    SIGKILL to those left after the grace; the seconds it took."""
    t0 = time.perf_counter()
    for sig, wait in ((signal.SIGTERM, DELETE_GRACE), (signal.SIGKILL, 60.0)):
        for proc in procs:
            try:
                os.killpg(proc.pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + wait
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            time.sleep(0.02)
        if all(p.poll() is not None for p in procs):
            break
    return time.perf_counter() - t0


def durable_steps(stream: str) -> list:
    """The steps of a DCP stream whose save finished (``.metadata``, which
    the coordinator writes after every rank's data); none before the
    stream's first save."""
    try:
        names = os.listdir(stream)
    except FileNotFoundError:
        return []
    return sorted(int(d) for d in names if os.path.exists(os.path.join(stream, d, ".metadata")))


def phase_t(build, peak, main: dict, timeout: float = 600.0) -> None:
    """The resize that one card holds, of an elastic 1-node x 1-card job
    of llama-400m (phase e's arguments, phase g's seeded token file,
    ELASTIC_STEPS steps, a checkpoint every ELASTIC_EVERY): U, the
    uninterrupted run, in this process; then the job's pod through the
    per-node launcher under :func:`elastic_env`. After its first durable
    step (the beat file, as the operator's shrink gate reads it),
    ``scale()`` to 2 nodes: the operator deletes the pod (:func:`delete_pods`)
    and, under ``--capacity nvidia.com/gpu@h100=1``, the 2-node job waits at
    the gate, so nothing runs; ``scale()`` back to 1 admits it, and the pod
    starts again with the same env. It must resume from storage at or after
    the durable step, with U's losses from there (LOSS_TOL) at phase e's
    launches a step. Prints the restore's seconds and split and the
    seconds from the scale back to the first resumed step."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = seeded_tokens(tmp)
        args = [*MAIN_ARGS, "--steps", str(ELASTIC_STEPS), "--data", path,
                "--data-dtype", "uint16"]
        unresized = train_run(build, peak, "t", args)
        gc.collect()
        torch.cuda.empty_cache()
        command = launch_argv(1, [
            sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", *args,
            "--checkpoint-every", str(ELASTIC_EVERY), "--checkpoint-dir",
            os.path.join(tmp, "ckpt")])
        port, logs, procs = free_port(), {}, []

        def start(tag: str):
            logs[tag] = os.path.join(tmp, f"{tag}.log")
            with open(logs[tag], "w") as out:
                procs.append(subprocess.Popen(
                    command, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                    env=elastic_env(port, os.path.join(tmp, f"{tag}.beat.json")),
                    start_new_session=True))
            return procs[-1]

        try:
            t0 = time.perf_counter()
            first, durable = start("first"), None
            while first.poll() is None and time.perf_counter() - t0 < timeout:
                durable = (read_json(os.path.join(tmp, "first.beat.json")) or {}).get(
                    "checkpoint_step")
                if durable is not None:
                    break
                time.sleep(0.05)
            running = first.poll() is None
            teardown = delete_pods([first])
            log(f"[t] 1 node x 1 card: durable step {durable} on its beat "
                f"{time.perf_counter() - t0:.1f} s after its start; scale() to 2 nodes: the pod "
                f"deleted in {teardown:.3f} s (exit {first.returncode}); 2 cards do not fit "
                f"nvidia.com/gpu@h100=1, so the job waits at the gate with no pod")
            if durable is None or not running:
                raise AssertionError(f"the first world made no durable step while it trained "
                                     f"(exit {first.returncode}):\n"
                                     f"{open(logs['first']).read()[-3000:]}")
            t1 = time.perf_counter()
            second, first_step = start("resumed"), None
            while second.poll() is None and time.perf_counter() - t1 < timeout:
                if first_step is None and STEP_LINE.search(open(logs["resumed"]).read()):
                    first_step = time.perf_counter() - t1
                time.sleep(0.05)
            second.wait(max(timeout - (time.perf_counter() - t1), 1.0))
            ended = time.perf_counter() - t1
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        text = open(logs["resumed"]).read()
        runs = done_lines(text)
        for line in text.splitlines():
            if line.startswith(("[gpu_init]", "[llama] process", "[llama] resumed")):
                log(f"[t] resumed| {line}")
        if second.returncode != 0 or list(runs) != [0] or first_step is None:
            raise AssertionError(f"the resumed world failed (exit {second.returncode}, a step "
                                 f"seen while it ran: {first_step is not None}):\n"
                                 f"{text[-3000:]}")
    run = runs[0]
    restore, k = run["restore"], run["start_step"]
    log(f"[t] scale() back to 1 node: resumed at step {k} via {restore['path']} "
        f"({restore['cause']}); restore {restore['seconds']:.3f} s, split {restore['split']}; "
        f"{first_step:.1f} s from the scale back to the first resumed step, "
        f"{ended:.1f} s to the job's end")
    if (restore["path"], restore["cause"]) != ("storage", "ok") or not (
            durable <= k < ELASTIC_STEPS and k % ELASTIC_EVERY == 0):
        raise AssertionError(f"the resumed world restored {restore} at step {k}, after the "
                             f"durable step {durable}")
    check_losses("t", f"resumed from step {k} against the unresized run", run["losses"],
                 unresized["losses"][k:])
    per_step = {n: run["launches"].get(n, 0) / len(run["losses"]) for n in KERNEL_SYMBOLS}
    want = {n: main["per_step"][n] for n in KERNEL_SYMBOLS}
    step_s = run["window_seconds"] / max(run["window_steps"], 1)
    log(f"[t] resumed world: {len(run['losses'])} steps, launches a step {per_step} (phase e: "
        f"{want}); step {step_s:.4f} s, tokens/s {run['tokens_per_step'] / step_s:.1f}; peak "
        f"{run['peak_bytes'] / 2**30:.3f} GiB; last persist {run['persist']}")
    if per_step != want:
        raise AssertionError(f"launches a step {per_step}, phase e {want}")


def recovery_legs() -> None:
    """``scripts/measure_recovery_torch.py`` on the card at llama-400m's
    state, one trial a leg, its gates on; its legs' seconds printed."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "measure_recovery_torch.py"),
             "--trials", "1", "--smoke", "--baseline", os.path.join(tmp, "baseline.json")],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[r] {line}")
    log(f"[r] measure_recovery_torch exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the recovery legs failed:\n{proc.stdout[-3000:]}"
                             f"{proc.stderr[-3000:]}")
    out = json.loads(lines[-1])
    restart = out["restart"]
    log(f"[r] legs: stall {out['snapshot_stall_s']} s, persist {out['persist_s']} s "
        f"{out['persist']['split']}; A storage {out['latency']['storage_raw_s']} s (modelled "
        f"{out['latency']['storage_modeled_s']}) peer {out['latency']['peer_s']} s; D restart "
        f"to resumed storage {restart['storage']['restart_to_resumed_s']} s, peer "
        f"{restart['peer']['restart_to_resumed_s']} s; E single "
        f"{out['sharded']['single_survivor_s']} s sharded {out['sharded']['sharded_restore_s']} "
        f"s; G {out['warm_start']['seconds']} s; H delta fraction "
        f"{out['delta']['delta_persist_fraction']}, have-list {out['delta']['have_list_fraction']}")


# Phase (u): the configurations of the JAX package no earlier phase ran,
# at full width and depth. llama-1b (dim 2048, 16 layers, 16 heads x 128,
# ffn 5504) through the entry point at phase e's batch and sequence under
# its config's policy, the reference's "dots+rope+norms", and under
# "dots"; bert-large (24 layers, 16 heads x 64) on phase l's bench path
# and through bert_train; resnet18 card against CPU and through
# resnet_train at phase p's image size and batch.
LLAMA_1B_ARGS = ["--model", "llama-1b", *MAIN_ARGS[2:]]
LLAMA_1B_SHAPE = dict(b=8, s=2048, h=16, kvh=16, d=128, causal=True)
BERT_LARGE_SHAPE = dict(b=BERT_BATCH, s=BERT_SEQ, h=16, kvh=16, d=64, causal=False)
RESNET18_STEPS = 5


def phase_u(build, peak, flash, rope_mod) -> dict:
    """llama-1b under both policies (step time, tokens/s, MFU, peak memory,
    launches a step; 4 losses within LOSS_TOL and one backward's
    gradients within GRAD_TOL of each other) and the four kernels at its
    shapes; bert-large's bench step (48/24/24 d=64 launches a step) and
    the d=64 kernels at its shape, and bert_train --model bert-large for 4
    steps; resnet18 card against CPU and through resnet_train. Returns the
    kernels' entries at llama-1b's and bert-large's shapes, with the
    launches of the reference policy's run and of bert-large's window."""
    import numpy as np

    from tf_operator_tpu_torch.models import bert, llama, resnet
    from tf_operator_tpu_torch.train import resnet_train

    policy = llama.CONFIGS["llama-1b"].remat_policy
    runs = {p: train_run(build, peak, "u", [*LLAMA_1B_ARGS, "--steps", "4",
                                            "--remat-policy", p])
            for p in (policy, "dots")}
    ref, dots = runs[policy], runs["dots"]
    if abs(ref["losses"][0] - math.log(ref["config"].vocab_size)) > 0.5:
        raise AssertionError(f"first loss {ref['losses'][0]} is far from ln(vocab)")
    log(f"[u] llama-1b ({ref['config'].param_count():,} parameters): {policy} step "
        f"{ref['step_s']:.4f} s, peak {ref['peak_gib']:.3f} GiB; dots step {dots['step_s']:.4f} s "
        f"({dots['step_s'] / ref['step_s']:.3f}x), peak {dots['peak_gib']:.3f} GiB "
        f"({dots['peak_gib'] - ref['peak_gib']:+.3f})")
    check_losses("u", f"llama-1b dots against {policy}", dots["losses"], ref["losses"])
    grads = first_grads([*LLAMA_1B_ARGS, "--remat-policy", policy])
    check_grads("u", f"llama-1b dots against {policy}",
                first_grads([*LLAMA_1B_ARGS, "--remat-policy", "dots"]), grads)
    del grads, runs, dots
    gc.collect()
    torch.cuda.empty_cache()
    results = phase_c(flash, rope_mod, peak, {"llama_1b": LLAMA_1B_SHAPE}, main="llama_1b",
                      label="u")
    for name, res in results.items():
        res["name"] = f"{name}[llama-1b]"
        res["launches"] = ref["launches"][name]
        res["launches_per_step"] = ref["per_step"][name]

    cfg = bert.CONFIGS["bert-large"]
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ + 1),
                                             dtype=np.int32)).cuda() for _ in range(BERT_STEPS)]
    large = bert_window(build, peak, "u", batches, model_name="bert-large")
    if abs(large["losses"][0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {large['losses'][0]} is far from ln(vocab)")
    del batches
    d64 = phase_c64(flash, peak, {"bert_large": BERT_LARGE_SHAPE}, main="bert_large",
                    label="u")
    for name, res in d64.items():
        res["name"] = f"{name}[bert-large]"
        res["launches"] = large["launches"][name]
        res["launches_per_step"] = large["per_step"][name]
    results.update({r["name"]: r for r in d64.values()})
    bert_train_steps("u", ["--model", "bert-large"])

    resnet_parity("resnet18", "u")
    flops = 3 * resnet.CONFIGS["resnet18"].forward_flops(RESNET["image"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = resnet_train.run(resnet_train.parse_args(
        ["--model", "resnet18", "--image-size", str(RESNET["image"]), "--batch",
         str(RESNET["batch"]), "--log-every", "100", "--steps", str(RESNET18_STEPS)]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = run["window_seconds"] / run["window_steps"]
    ips = run["images_per_step"] / step_s
    log(f"[u] resnet_train resnet18 {RESNET['image']}x{RESNET['image']} global batch "
        f"{RESNET['batch']}: losses {run['losses']}; window of {run['window_steps']} steps in "
        f"{run['window_seconds']:.4f} s: step {step_s:.4f} s, images/s {ips:.1f}, MFU "
        f"{ips * flops / (peak.bf16_tflops * 1e12):.4f} ({flops:.4e} FLOP an image); peak "
        f"device memory {peak_gb:.3f} GB")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"non-finite loss {run['losses']}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return results


# Phase (v): the flash kernels at head dims that are multiples of 16 other
# than 64 and 128. 16 and 32 go to the 64-wide instances, 80 and 96 to the
# 128-wide ones with their tiles' last columns zero-filled, 192 and 256 to
# the 256-wide ones (at 192 the last 64-column box lies wholly past the
# head dim). Each head dim also trains a 2-layer llama-tiny of 4 heads of
# it (its launches a step are the kernels line's); the JAX package's tiny
# configurations (head_dim 16) run card against CPU; llama-400m's widths
# regrouped as 4 heads of 256 train at phase e's batch and sequence.
HEAD_DIMS_V = (16, 32, 80, 96, 192, 256)
SWEEP_ARGS = ["--model", "llama-tiny", "--batch", "8", "--seq", "128", "--steps", "2",
              "--log-every", "100", "--warmup", "1"]
TINY_STEPS = 4
D256_HEADS = dict(n_heads=4, n_kv_heads=4)  # llama-400m's dim 1024 as 4 heads of 256


def tiny_steps(name: str, device: str, weights=None, dtype=None) -> tuple[list, dict, dict]:
    """TINY_STEPS steps of ``name`` on ``device``, from ``weights`` (a state
    dict; by default seed 0's draw on the device), with the launch counters
    reset just before: llama-tiny and moe-tiny through llama_train (its
    setup and run, the synthetic batches), bert-tiny through the bench path
    (``make_train_step`` with the next-token ``loss_fn``, no padding mask,
    so that attention runs the flash kernels, as phase l's) on seeded
    batches; with ``dtype``, the configuration's dtype and param_dtype
    replaced by it. Returns the losses, the launches a step and the weights
    the run started from, on the CPU."""
    import numpy as np

    from tf_operator_tpu_torch.models import bert, llama
    from tf_operator_tpu_torch.ops import build
    from tf_operator_tpu_torch.train import llama_train
    from tf_operator_tpu_torch.train.train_step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    def typed(cfg):
        return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)

    if name.startswith("bert"):
        cfg = typed(bert.CONFIGS[name])
        model = bert.Bert(cfg, device=device, generator=torch.Generator(device).manual_seed(0))
    else:
        args = llama_train.parse_args(["--model", name, "--batch", "8", "--seq", "128",
                                       "--steps", str(TINY_STEPS), "--log-every", "100",
                                       "--warmup", "1", "--device", device])
        setup = llama_train.setup(args, config=typed(llama.CONFIGS[name]))
        model = setup.state.model
    if weights is not None:
        model.load_state_dict(weights)
    start = {k: t.detach().to("cpu", copy=True) for k, t in model.state_dict().items()}
    if name.startswith("bert"):
        optimizer = make_optimizer(warmup_steps=1, decay_steps=1000)
        state, step_fn = init_train_state(model, optimizer), make_train_step(optimizer)
        rng = np.random.default_rng(16)
        batches = [rng.integers(0, cfg.vocab_size, (8, cfg.max_len + 1), dtype=np.int32)
                   for _ in range(TINY_STEPS)]
        build.reset_launches()
        losses = []
        for batch in batches:
            state, loss = step_fn(state, batch)
            losses.append(float(loss))
    else:
        build.reset_launches()
        losses = llama_train.run(args, setup)["losses"]
    per_step = {k: n / TINY_STEPS for k, n in build.LAUNCHES.items()}
    return losses, per_step, start


def tiny_parity(build) -> None:
    """llama-tiny, moe-tiny and bert-tiny (head_dim 16, the 64-wide
    instances): one loss and its gradients card (bf16) against CPU (fp32)
    at PARITY_TOL (moe-tiny's experts and router at MOE_ROUTED_TOL), then
    TINY_STEPS steps on the CPU (plain versions, the config's bf16) and on
    the card from the CPU model's weights (:func:`tiny_steps`), their
    losses within PARITY_TOL's loss share; the card's launches a step must
    be expected_launches' on the _d64 kernels."""
    import numpy as np

    from tf_operator_tpu_torch.models import bert, llama

    rng = np.random.default_rng(16)
    for name in ("llama-tiny", "moe-tiny", "bert-tiny"):
        is_bert = name.startswith("bert")
        cfg = (bert.CONFIGS if is_bert else llama.CONFIGS)[name]
        seq = cfg.max_len if is_bert else cfg.max_seq_len
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, seq + 1))).long()
        if getattr(cfg, "n_experts", 0):
            moe_parity(tokens, cfg, "v")
        else:
            card_cpu_parity("v", bert.Bert if is_bert else llama.Llama, cfg, tokens)
        cpu, _, start = tiny_steps(name, "cpu")
        card, per_step, _ = tiny_steps(name, "cuda", start)
        worst = max(rel(a, b) for a, b in zip(card, cpu))
        log(f"[v] {name} {TINY_STEPS} steps: losses card {card} cpu {cpu}, worst rel "
            f"{worst:.3e} (tol {PARITY_TOL['loss']}); card launches a step {per_step}")
        if len(card) != len(cpu) or not worst <= PARITY_TOL["loss"]:
            raise AssertionError(f"{name}: card losses {card} against the CPU's {cpu}")
        want = expected_launches("dots", cfg.n_layers, cfg.dim // cfg.n_heads, cfg.remat)
        if is_bert:  # no rope
            want["rope"] = 0
        if per_step != want:
            raise AssertionError(f"{name}: launches a step {per_step}, expected {want}")
        gc.collect()


def row_grads(argv: list, cfg, device: str = "cuda", weights=None) -> tuple[float, dict, dict]:
    """(loss, {name: fp32 gradient on the CPU}, the weights on the CPU) of
    one forward and backward of the entry point's model of ``cfg`` (seed
    0's draw, or ``weights``) on ``device``, on the first row of its first
    batch."""
    from tf_operator_tpu_torch.train import llama_train
    from tf_operator_tpu_torch.train.train_step import loss_fn

    gc.collect()
    torch.cuda.empty_cache()
    s = llama_train.setup(llama_train.parse_args([*argv, "--device", device]), config=cfg)
    model = s.state.model
    if weights is not None:
        model.load_state_dict(weights)
    loss = loss_fn(model, torch.as_tensor(next(s.dataset))[:1].to(device).long())
    loss.backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    weights = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    del s, model
    return loss.item(), grads, weights


def worst_rel(got: dict, ref: dict) -> tuple[float, str]:
    """The largest relative L2 distance of a gradient from its reference,
    and its parameter's name."""
    return max((((g - ref[n]).norm() / ref[n].norm().clamp(min=1e-30)).item(), n)
               for n, g in got.items())


def grads_against_fp32(argv: list, cfg, what: str) -> None:
    """One backward of ``cfg`` on the card through the kernels and through
    the plain "xla" attention (both bf16), and on the CPU in fp32 ("xla",
    the same weights): one row of the first batch. Two bf16 backwards of 24
    layers round at other places and differ by about 2.5e-2 (rel L2)
    whatever their attention, at 8 x 128 as at 4 x 256, so the kernels'
    gradients are held to the fp32 ones: no further than the xla run's,
    plus GRAD_TOL; the loss within LOSS_TOL of fp32's."""
    xla_cfg = dataclasses.replace(cfg, attention_impl="xla")
    fp32_cfg = dataclasses.replace(xla_cfg, dtype=torch.float32, param_dtype=torch.float32)
    loss_f, flash_g, weights = row_grads(argv, cfg)
    loss_x, xla_g, _ = row_grads(argv, xla_cfg, weights=weights)
    t0 = time.perf_counter()
    loss_32, ref_g, _ = row_grads(argv, fp32_cfg, "cpu", weights)
    gap, gap_name = worst_rel(flash_g, xla_g)
    err_f, name_f = worst_rel(flash_g, ref_g)
    err_x, name_x = worst_rel(xla_g, ref_g)
    log(f"[v] {what}, one row's backward: losses flash {loss_f:.6f} xla {loss_x:.6f} fp32 "
        f"{loss_32:.6f} (cpu {time.perf_counter() - t0:.1f} s); worst gradient rel L2 flash "
        f"against xla {gap:.3e} at {gap_name}; against fp32: flash {err_f:.3e} at {name_f}, "
        f"xla {err_x:.3e} at {name_x} (flash held to xla's + {GRAD_TOL})")
    if not rel(loss_f, loss_32) <= LOSS_TOL or not err_f <= err_x + GRAD_TOL:
        raise AssertionError(f"{what}: the kernels' loss {loss_f} or gradients (rel L2 "
                             f"{err_f:.3e} at {name_f}) stray from fp32's {loss_32} beyond "
                             f"the xla run's {err_x:.3e} + {GRAD_TOL}")
    del flash_g, xla_g, ref_g, weights
    gc.collect()
    torch.cuda.empty_cache()


def phase_v(build, peak, flash, rope_mod) -> dict:
    """Phase c's checks and timings at every head dim of HEAD_DIMS_V; a
    2-layer model of each trained 2 steps (launches a step); the tiny
    configurations card against CPU (:func:`tiny_parity`); llama-400m as 4
    heads of 256 at bs 8, seq 2048, 4 steps (step time, tokens/s, MFU,
    peak memory, launches a step) with its losses within LOSS_TOL of the
    same model and weights under the plain "xla" attention on the card,
    and one backward's gradients held to fp32, as llama-400m's own 8 x 128
    are (:func:`grads_against_fp32`).
    Returns the kernels' entries, named "<counter>[d<head_dim>]"."""
    from tf_operator_tpu_torch.models import llama

    results = {}
    for d in HEAD_DIMS_V:
        cases = {f"{name}_d{d}": dict(c, d=d) for name, c in CASES.items()}
        for kernel, res in phase_c(flash, rope_mod, peak, cases, main=f"main_d{d}",
                                   label="v").items():
            res["counter"] = kernel if kernel == "rope" else flash.kernel_name(kernel, d)
            res["name"] = f"{res['counter']}[d{d}]"
            res["head_dim"] = d
            results[res["name"]] = res
        gc.collect()
        torch.cuda.empty_cache()
    # llama-tiny (4 heads, 2 KV heads, 2 layers) at each head dim.
    runs = {d: train_run(build, peak, "v", SWEEP_ARGS, config=dataclasses.replace(
                llama.CONFIGS["llama-tiny"], dim=4 * d, ffn_dim=8 * d))
            for d in HEAD_DIMS_V}
    tiny_parity(build)

    cfg = dataclasses.replace(llama.CONFIGS["llama-400m"], **D256_HEADS)
    argv = [*MAIN_ARGS, "--steps", "4"]
    full = train_run(build, peak, "v", argv, config=cfg)
    xla_cfg = dataclasses.replace(cfg, attention_impl="xla")
    xla = train_run(build, peak, "v", argv, config=xla_cfg)
    launched = {k: n for k, n in full["per_step"].items() if n}
    log(f"[v] llama-400m as 4 heads x 256 ({cfg.param_count():,} parameters): step "
        f"{full['step_s']:.4f} s, tokens/s {full['tokens_per_s']:.1f}, MFU {full['mfu']:.4f}, "
        f"peak {full['peak_gib']:.3f} GiB, launches a step {launched}; under the plain xla "
        f"attention step {xla['step_s']:.4f} s, peak {xla['peak_gib']:.3f} GiB")
    if abs(full["losses"][0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {full['losses'][0]} is far from ln(vocab)")
    check_losses("v", "4 x 256 flash kernels against xla", full["losses"], xla["losses"])
    del xla
    grads_against_fp32(argv, cfg, "4 x 256")
    grads_against_fp32(argv, llama.CONFIGS["llama-400m"], "llama-400m, 8 x 128")
    for res in results.values():
        run = full if res["head_dim"] == 256 else runs[res["head_dim"]]
        res["launches"] = run["launches"][res["counter"]]
        res["launches_per_step"] = run["per_step"][res["counter"]]
    return results


# Phase (w): fp32 through the four kernels, and the head dims that are a
# multiple of 8 but not of 16. The fp32 kernels are checked in every case
# at a head dim on each instance width (16 and 64 on the 64-wide, 128,
# 256), and each width's instances timed at [8, 2048, 8, D] causal; 8 and
# 24 go to the 64-wide instances, 72 to the 128-wide and 136 to the
# 256-wide, in both dtypes. llama-400m trains in fp32 at full width and
# depth, and the JAX package's tiny configurations run in fp32 card against
# CPU.
HEAD_DIMS_W = (16, 64, 128, 256)
TIMED_W = (64, 128, 256)
NEW_HEAD_DIMS = (8, 24, 72, 136)
# fp32 on both sides: the card's kernels and the CPU's plain versions sum
# in other orders (unit roundoff 6e-8) over 2 layers (tiny) or 24
# (llama-400m); a loss or gradient that a kernel got wrong differs by far
# more.
PARITY_TOL_F32 = 1e-4
LOSS_TOL_F32 = 1e-5
GRAD_TOL_F32 = 1e-4
# The large-logit cases: q times LARGE_LOGIT makes the softmax peaky (scores
# of a few tens), where an error in the products' low bits shows most; at
# the head dims of the 64- and 128-wide 3xTF32 kernels, at TOL_F32.
LARGE_LOGIT = 8.0
LARGE_LOGIT_DIMS = (64, 128)
LARGE_LOGIT_CASES = ("gqa_8_2", "cross_ragged")


def fp32_tiny_parity(build) -> None:
    """llama-tiny, moe-tiny and bert-tiny in fp32 (head_dim 16: the fp32
    _d64 kernels) from one set of seeded weights: one forward and backward
    on the card (kernels) against the CPU (plain versions), the loss and
    every gradient (rel L2) within PARITY_TOL_F32 (BERT's key bias, whose
    exact gradient is 0, by its norm beside the query bias's); then
    TINY_STEPS steps on each side from the same weights, their losses
    within PARITY_TOL_F32 and the card's launches a step
    expected_launches' in fp32."""
    import numpy as np

    from tf_operator_tpu_torch.models import bert, llama
    from tf_operator_tpu_torch.train.train_step import loss_fn

    f32 = torch.float32
    rng = np.random.default_rng(32)
    for name in ("llama-tiny", "moe-tiny", "bert-tiny"):
        is_bert = name.startswith("bert")
        model_cls = bert.Bert if is_bert else llama.Llama
        cfg = dataclasses.replace((bert.CONFIGS if is_bert else llama.CONFIGS)[name],
                                  dtype=f32, param_dtype=f32)
        seq = cfg.max_len if is_bert else cfg.max_seq_len
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, seq + 1))).long()
        cpu_model = model_cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        card_model = model_cls(cfg, device="cuda")
        card_model.load_state_dict(cpu_model.state_dict())
        build.reset_launches()
        card_loss = loss_fn(card_model, tokens.cuda())
        card_loss.backward()
        launched = {k: n for k, n in build.LAUNCHES.items() if n}
        cpu_loss = loss_fn(cpu_model, tokens)
        cpu_loss.backward()
        cpu_g = {n: p.grad for n, p in cpu_model.named_parameters()}
        card_g = {n: p.grad.cpu() for n, p in card_model.named_parameters()}
        zero = [n for n in card_g if n.endswith(ZERO_GRAD)]
        noise = max((card_g[n].norm() / cpu_g[n.replace(ZERO_GRAD, ".query.bias")].norm()).item()
                    for n in zero) if zero else 0.0
        worst, worst_name = worst_rel({n: g for n, g in card_g.items() if n not in zero}, cpu_g)
        loss_rel = rel(card_loss.item(), cpu_loss.item())
        log(f"[w] {name} fp32, one backward: loss card {card_loss.item():.7f} cpu "
            f"{cpu_loss.item():.7f} rel {loss_rel:.3e}; worst gradient rel L2 {worst:.3e} at "
            f"{worst_name} over {len(card_g)} parameters"
            + (f"; largest zero-gradient norm {noise:.3e} of the query bias's" if zero else "")
            + f" (tol {PARITY_TOL_F32}); card launches {launched}")
        if not max(loss_rel, worst, noise) <= PARITY_TOL_F32:
            raise AssertionError(f"{name} fp32: card against CPU loss {loss_rel:.3e}, gradient "
                                 f"{worst:.3e} at {worst_name}, zero-gradient {noise:.3e}")
        if "flash_fwd_f32_d64" not in launched or any("_f32" not in k for k in launched):
            raise AssertionError(f"{name} fp32: launches {launched} are not the fp32 kernels'")
        del cpu_model, card_model, cpu_g, card_g
        cpu, _, start = tiny_steps(name, "cpu", dtype=f32)
        card, per_step, _ = tiny_steps(name, "cuda", start, dtype=f32)
        worst = max(rel(a, b) for a, b in zip(card, cpu))
        log(f"[w] {name} fp32, {TINY_STEPS} steps: losses card {card} cpu {cpu}, worst rel "
            f"{worst:.3e} (tol {PARITY_TOL_F32}); card launches a step {per_step}")
        if len(card) != len(cpu) or not worst <= PARITY_TOL_F32:
            raise AssertionError(f"{name} fp32: card losses {card} against the CPU's {cpu}")
        want = expected_launches("dots", cfg.n_layers, cfg.dim // cfg.n_heads, cfg.remat,
                                 dtype=f32)
        if is_bert:  # no rope
            want["rope_f32"] = 0
        if per_step != want:
            raise AssertionError(f"{name} fp32: launches a step {per_step}, expected {want}")
        gc.collect()


def kernel_design(flash, kernel: str, d: int, dtype) -> str:
    """What an entry's kernel runs on: rope's elementwise pass; the flash
    kernels' bf16 wgmma, and in fp32 3xTF32 wgmma but for dQ and dK/dV at
    the 256-wide instance, FMAs on the CUDA cores."""
    if kernel == "rope":
        return "elementwise"
    if dtype != torch.float32:
        return "wgmma bf16"
    if kernel != "flash_fwd" and flash.kernel_width(d) == 256:
        return "fma fp32"
    return "wgmma 3xtf32"


def phase_w(build, peak, flash, rope_mod) -> dict:
    """fp32 through the kernels (phase c's checks at TOL_F32 in CASES and
    CASES_D64 at HEAD_DIMS_W, each instance width timed at [8, 2048, 8, D]
    causal); phase c's checks at NEW_HEAD_DIMS in bf16 and fp32, each timed
    at [8, 2048, 8, D]; a 2-layer llama-tiny of 4 heads of each of those in
    both dtypes (2 steps, launches a step); llama-400m in fp32 against the
    same weights under the fp32 "xla" attention (losses within
    LOSS_TOL_F32, one row's gradients within GRAD_TOL_F32); and
    :func:`fp32_tiny_parity`. Returns the fp32 kernels' entries and those
    at NEW_HEAD_DIMS, named "<counter>[d<head_dim>]"."""
    from tf_operator_tpu_torch.models import llama

    f32 = torch.float32
    t0 = time.perf_counter()
    all_cases = {**CASES, **CASES_D64}
    results, run_of = {}, {}

    def checks(d, dtype, tol, timed, run_key):
        """Phase c's checks at head dim d in every case, timed at
        main_d<d> when ``timed``; the entries' launches come from the run
        ``run_key`` of ``runs`` (None: the fp32 llama-400m)."""
        cases = {f"{name}_d{d}": dict(c, d=d) for name, c in all_cases.items()}
        entries = phase_c(flash, rope_mod, peak, cases, main=f"main_d{d}" if timed else None,
                          label="w", dtype=dtype, tol=tol)
        for kernel, res in entries.items():
            res["counter"] = (rope_mod.kernel_name(dtype) if kernel == "rope"
                              else flash.kernel_name(kernel, d, dtype))
            res["name"] = f"{res['counter']}[d{d}]"
            res["head_dim"] = d
            res["design"] = kernel_design(flash, kernel, d, dtype)
            results[res["name"]] = res
            run_of[res["name"]] = run_key
        gc.collect()
        torch.cuda.empty_cache()

    for d in HEAD_DIMS_W:
        checks(d, f32, TOL_F32, d in TIMED_W, None if d == 128 else (24 if d == 64 else 136, f32))
    gen = torch.Generator(device="cuda").manual_seed(8)
    for d in LARGE_LOGIT_DIMS:
        for name in LARGE_LOGIT_CASES:
            c = dict(CASES[name], d=d)
            q, k, v, do, dlse = case_inputs(c, gen, dtype=f32)
            check_flash(flash, f"{name}_d{d}_x{LARGE_LOGIT:g}", q * LARGE_LOGIT, k, v, do, dlse,
                        c["causal"], "w", TOL_F32)
            del q, k, v, do, dlse
    t1 = time.perf_counter()
    for d in NEW_HEAD_DIMS:
        for dtype, tol in ((torch.bfloat16, TOL), (f32, TOL_F32)):
            checks(d, dtype, tol, True, (d, dtype))
    t2 = time.perf_counter()
    # llama-tiny (4 heads, 2 KV heads, 2 layers) at each new head dim.
    runs = {(d, dtype): train_run(build, peak, "w", SWEEP_ARGS, config=dataclasses.replace(
                llama.CONFIGS["llama-tiny"], dim=4 * d, ffn_dim=8 * d, dtype=dtype,
                param_dtype=dtype))
            for d in NEW_HEAD_DIMS for dtype in (torch.bfloat16, f32)}
    t3 = time.perf_counter()
    fp32_tiny_parity(build)
    t4 = time.perf_counter()

    cfg = dataclasses.replace(llama.CONFIGS["llama-400m"], dtype=f32, param_dtype=f32)
    xla_cfg = dataclasses.replace(cfg, attention_impl="xla")
    argv = [*MAIN_ARGS, "--steps", "4"]
    full = train_run(build, peak, "w", argv, config=cfg)
    xla = train_run(build, peak, "w", argv, config=xla_cfg)
    launched = {k: n for k, n in full["per_step"].items() if n}
    log(f"[w] llama-400m in fp32 ({cfg.param_count():,} parameters): step "
        f"{full['step_s']:.4f} s, tokens/s {full['tokens_per_s']:.1f}, MFU {full['mfu']:.4f} "
        f"against a third of the TF32 peak (3xTF32), peak {full['peak_gib']:.3f} GiB, "
        f"launches a step {launched}; under the plain fp32 xla attention step "
        f"{xla['step_s']:.4f} s, peak {xla['peak_gib']:.3f} GiB")
    if abs(full["losses"][0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {full['losses'][0]} is far from ln(vocab)")
    worst = max(rel(a, b) for a, b in zip(full["losses"], xla["losses"]))
    log(f"[w] llama-400m fp32, flash kernels against xla: losses {full['losses']} against "
        f"{xla['losses']}: worst rel {worst:.3e} (tol {LOSS_TOL_F32})")
    if len(full["losses"]) != len(xla["losses"]) or not worst <= LOSS_TOL_F32:
        raise AssertionError(f"llama-400m fp32: losses differ from xla's by {worst:.3e}")
    del xla
    loss_f, flash_g, weights = row_grads(argv, cfg)
    loss_x, xla_g, _ = row_grads(argv, xla_cfg, weights=weights)
    gap, gap_name = worst_rel(flash_g, xla_g)
    log(f"[w] llama-400m fp32, one row's backward: loss flash {loss_f:.7f} xla {loss_x:.7f} "
        f"rel {rel(loss_f, loss_x):.3e} (tol {LOSS_TOL_F32}); worst gradient rel L2 {gap:.3e} "
        f"at {gap_name} over {len(flash_g)} parameters (tol {GRAD_TOL_F32})")
    if not rel(loss_f, loss_x) <= LOSS_TOL_F32 or not gap <= GRAD_TOL_F32:
        raise AssertionError(f"llama-400m fp32: the kernels' loss {loss_f} against xla's "
                             f"{loss_x}, or gradient of {gap_name} {gap:.3e} apart")
    del flash_g, xla_g, weights
    gc.collect()
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    log(f"[w] seconds: fp32 kernels {t1 - t0:.1f}, new head dims {t2 - t1:.1f}, 2-layer runs "
        f"{t3 - t2:.1f}, tiny parity {t4 - t3:.1f}, llama-400m fp32 {t5 - t4:.1f}")
    for name, res in results.items():
        run = full if run_of[name] is None else runs[run_of[name]]
        res["launches"] = run["launches"][res["counter"]]
        res["launches_per_step"] = run["per_step"][res["counter"]]
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from tf_operator_tpu_torch.device import peak_for
    from tf_operator_tpu_torch.ops import build, flash
    from tf_operator_tpu_torch.ops import rope as rope_mod

    # Plain float32 products on the card in full float32 (the references).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = smi_line()
    log(f"[a] {smi}")
    kind = torch.cuda.get_device_name(0)
    peak, assumed = peak_for(kind)
    log(f"[a] {kind}: peak {peak}" + (f" (assumed {assumed})" if assumed else ""))

    t0 = time.perf_counter()
    build.load()
    log(f"[b] build + load {time.perf_counter() - t0:.1f} s -> {build.library_path()}")
    for line in build.compiler_report().splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "warning")):
            log(f"[b] {line.strip()}")
    probe = flash.tf32_probe()
    log(f"[b] tf32 operand probe: truncates {probe['truncates']}, rounds {probe['rounds']}, "
        f"exact {probe['exact']}, register A fragment layout {probe['fragment_layout']}; "
        f"read {probe['values']}")
    if not (probe["truncates"] and probe["fragment_layout"]):
        raise AssertionError("the fp32 kernels assume a tensor core that truncates an fp32 "
                             f"operand to TF32 and their A fragment layout: {probe}")

    results = phase_c(flash, rope_mod, peak)
    d64 = phase_c64(flash, peak)
    phase_d()
    main = phase_e(build, peak)
    dots_grads = phase_f(build, peak)
    phase_g(build, peak)
    phase_h(build, peak, main["losses"], dots_grads)
    del dots_grads
    phase_i(build, peak)
    phase_j()
    moe, moe_losses = phase_k(build, peak, flash, rope_mod)
    bert_run = phase_l(build, peak)
    phase_m(build, peak, moe_losses, bert_run)
    phase_n()
    phase_o(build)
    phase_p(peak)
    phase_q(main)
    phase_r(main)
    phase_s()
    phase_t(build, peak, main)
    configs = phase_u(build, peak, flash, rope_mod)
    head_dims = phase_v(build, peak, flash, rope_mod)
    fp32 = phase_w(build, peak, flash, rope_mod)
    for name, res in results.items():
        res["launches"] = main["launches"][name]
        res["launches_per_step"] = main["per_step"][name]
    for name, res in d64.items():
        res["launches"] = bert_run["launches"][name]
        res["launches_per_step"] = bert_run["launches"][name] / BERT_STEPS

    log(smi_line())
    log(json.dumps({"kernels": list(results.values()) + list(moe.values())
                    + list(d64.values()) + list(configs.values())
                    + list(head_dims.values()) + list(fp32.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
