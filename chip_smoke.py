"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  (a) card: the nvidia-smi name and power limit;
  (b) build: nvcc builds every kernel of tf_operator_tpu_torch/ops/csrc
      into build/torch_kernels/ (timed; registers and spills printed);
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
      c's checks and timings at moe-125m's shapes [8, 2048, 6, 128].

Phases e-k each reset the launch counters just before their runs and read
them just after. The last lines are the nvidia-smi line, one JSON line of
per-kernel results (launches from phase e, and from phase k's einsum run
for the entries named "...[moe-125m]", timed at its shapes), and {"ok":
true, "device": {...}}.
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
# Phase (d): bf16 kernels on the card against fp32 plain on the CPU.
PARITY_TOL = {"loss": 1e-2, "grad_norm": 5e-2}
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


def phase_c(flash, rope_mod, peak, cases=CASES, dev="cuda", main="main", label="c"):
    """Each kernel against its plain version; returns per-kernel results at
    the shapes of the case named ``main``. Lines carry ``[label]``."""
    from tf_operator_tpu_torch.models.llama import rope_table

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for case, c in cases.items():
        b, s, h, kvh, d = c["b"], c["s"], c["h"], c["kvh"], c["d"]
        s_k = c.get("s_k", s)

        def randn(*shape):
            return torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)

        q, k, v = randn(b, s, h, d), randn(b, s_k, kvh, d), randn(b, s_k, kvh, d)
        do, dlse = randn(b, s, h, d), torch.randn(b, h, s, device=dev, generator=gen)
        cos, sin = rope_table(d, s, 10000.0, dev)

        err = {}
        err["rope"] = check("rope", case, rope_mod.rope_cuda(q, cos, sin),
                            rope_mod.rope_plain(q, cos, sin), TOL["rope"], label)
        err["rope_bwd"] = check("rope", case + "-bwd", rope_mod.rope_cuda(do, cos, sin, True),
                                rope_mod.rope_plain(do, cos, sin, True), TOL["rope"], label)
        causal = c["causal"]
        o, lse = flash.flash_forward_cuda(q, k, v, causal)
        po, plse = flash.flash_forward_plain(q, k, v, causal)
        err["o"] = check("o", case, o, po, TOL["o"], label)
        err["lse"] = check("lse", case, lse, plse, TOL["lse"], label)
        for tag, cot in (("", None), ("+dlse", dlse)):
            delta = flash.flash_delta(do, o, cot)
            dq = flash.flash_dq_cuda(q, k, v, do, lse, delta, causal)
            pdq = flash.flash_dq_plain(q, k, v, do, lse, delta, causal)
            dk, dv = flash.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
            pdk, pdv = flash.flash_dkv_plain(q, k, v, do, lse, delta, causal)
            err["dq" + tag] = check("dq", case + tag, dq, pdq, TOL["dq"], label)
            err["dk" + tag] = check("dk", case + tag, dk, pdk, TOL["dk"], label)
            err["dv" + tag] = check("dv", case + tag, dv, pdv, TOL["dv"], label)
        if case != main:
            continue

        delta = flash.flash_delta(do, o)
        fw = flash.flash_work(b, s, s_k, h, kvh, d, causal)
        work = {
            # name: (kernel, plain, library, bytes moved, tensor-core flops)
            "rope": (lambda: rope_mod.rope_cuda(q, cos, sin),
                     lambda: rope_mod.rope_plain(q, cos, sin), None,
                     *rope_mod.rope_work(b, s, h, d)),
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
            t_bytes = nbytes / (peak.hbm_tbps * 1e12) * 1e3
            t_ops = flops / (peak.bf16_tflops * 1e12) * 1e3
            res = {
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": None,
                "max_abs_err": errs[name],
                "ms": time_ms(kern, graph=name == "rope"),
                "plain_ms": time_ms(plain, iters=5, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "library_ms": time_ms(lib) if lib is not None else None,
            }
            log(f"[{label}] {name}: {res['ms']:.4f} ms, {res['bound_ms'] / res['ms']:.3f} of its "
                f"bound (plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
                f"{res['bound_by']}, library {res['library_ms']}) bytes {nbytes} flops {flops}")
            results[name] = res
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


def phase_d():
    """2 layers at llama-400m width: card (kernels, bf16) vs CPU (plain, fp32)."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.train.data import SyntheticTokens
    from tf_operator_tpu_torch.train.train_step import loss_fn

    cfg = dataclasses.replace(llama.CONFIGS["llama-400m"], n_layers=2, max_seq_len=2048)
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    cpu_model = llama.Llama(cpu_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu_model = llama.Llama(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.from_numpy(next(SyntheticTokens(1, 2048, cfg.vocab_size, seed=1))).long()

    t0 = time.perf_counter()
    gpu_loss = loss_fn(gpu_model, tokens.cuda())
    gpu_loss.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_loss = loss_fn(cpu_model, tokens)
    cpu_loss.backward()
    t2 = time.perf_counter()
    log(f"[d] loss card {gpu_loss.item():.6f} cpu {cpu_loss.item():.6f} "
        f"(card {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
    rel = abs(gpu_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    if not rel <= PARITY_TOL["loss"]:
        raise AssertionError(f"loss differs by {rel:.3e} relative")
    cpu_params = dict(cpu_model.named_parameters())
    worst, worst_name = 0.0, ""
    for name, p in gpu_model.named_parameters():
        g, ref = p.grad.float().norm().item(), cpu_params[name].grad.norm().item()
        r = abs(g - ref) / max(ref, 1e-30)
        if not r <= worst:
            worst, worst_name = r, name
    log(f"[d] loss rel {rel:.3e} (tol {PARITY_TOL['loss']}); worst grad-norm rel "
        f"{worst:.3e} at {worst_name} (tol {PARITY_TOL['grad_norm']})")
    if not worst <= PARITY_TOL["grad_norm"]:
        raise AssertionError(f"gradient norm of {worst_name} differs by {worst:.3e}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()


def expected_launches(policy: str, layers: int) -> dict:
    """Kernel launches per training step: the forward's two ropes and one
    flash forward per layer, the backward's two ropes, dQ and dK/dV, and
    the replay of what the policy does not save."""
    saved = set(policy.split("+"))
    return {"rope": (4 if "rope" in saved else 6) * layers,
            "flash_fwd": (1 if "dots" in saved else 2) * layers,
            "flash_dq": layers, "flash_dkv": layers}


def train_run(build, peak, phase: str, argv: list) -> dict:
    """One llama_train run with the launch counters and the peak device
    memory reset just before it and read just after; prints and returns
    losses, the step time of its window (from the host's read of the first
    step's loss to its read of the last's), tokens/s, MFU, peak memory and
    launches."""
    from tf_operator_tpu_torch.train import llama_train

    gc.collect()
    torch.cuda.empty_cache()
    args = llama_train.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = llama_train.run(args)
    out["launches"] = dict(build.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    steps = len(out["losses"])
    if out["window_steps"] < 1:
        raise AssertionError(f"a window of {out['window_steps']} steps times nothing")
    out["step_s"] = out["window_seconds"] / out["window_steps"]
    out["tokens_per_s"] = out["tokens_per_step"] / out["step_s"]
    out["mfu"] = (out["tokens_per_s"] * out["config"].flops_per_token(args.seq)
                  / (peak.bf16_tflops * 1e12))
    out["per_step"] = {k: n / steps for k, n in out["launches"].items()}
    policy = out["config"].remat_policy
    log(f"[{phase}] remat_policy {policy}: losses {out['losses']}")
    log(f"[{phase}] remat_policy {policy}: window of {out['window_steps']} steps in "
        f"{out['window_seconds']:.4f} s (the first step, the warm-up, outside); step "
        f"{out['step_s']:.4f} s, tokens/s "
        f"{out['tokens_per_s']:.1f}, MFU {out['mfu']:.4f} (peak {peak.bf16_tflops} "
        f"TFLOP/s); peak device memory {out['peak_gib']:.3f} GiB")
    log(f"[{phase}] remat_policy {policy}: launches in {steps} steps {out['launches']}, "
        f"per step {out['per_step']}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss {out['losses']}")
    want = expected_launches(policy, out["config"].n_layers)
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

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
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


def moe_parity(tokens) -> None:
    """Two layers at full width: the card (kernels, bf16) against the CPU
    (plain versions, fp32), from the same weights."""
    from tf_operator_tpu_torch.models import llama

    cfg = moe_config(n_layers=2)
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
    log(f"[k] parity at 2 layers: loss card {card_loss:.6f} cpu {cpu_loss:.6f}, rel "
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
    log(f"[k] parity at 2 layers: worst grad-norm rel {dense:.3e} at {dense_name} (tol "
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
    its main run."""
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

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
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
    return results


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

    results = phase_c(flash, rope_mod, peak)
    phase_d()
    main = phase_e(build, peak)
    dots_grads = phase_f(build, peak)
    phase_g(build, peak)
    phase_h(build, peak, main["losses"], dots_grads)
    del dots_grads
    phase_i(build, peak)
    phase_j()
    moe = phase_k(build, peak, flash, rope_mod)
    for name, res in results.items():
        res["launches"] = main["launches"][name]
        res["launches_per_step"] = main["per_step"][name]

    log(smi_line())
    log(json.dumps({"kernels": list(results.values()) + list(moe.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
