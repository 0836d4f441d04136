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
      port never calls it); for rope also its time by events without a
      graph, the host cost of a wrapper call, and a copy of x both ways;
  (d) full-width parity: a 2-layer model at llama-400m width from one set
      of seeded weights, bs 1, seq 2048: loss and per-parameter gradient
      norms on the card (kernels, bf16) against the CPU (plain, fp32);
  (e) training: llama-400m at full width and depth through the
      llama_train entry point, 1 warm-up step and 3 timed steps at bs 8,
      seq 2048, with the kernels' launch counters reset just before and
      read just after (reported per run and per step).

The last lines are the nvidia-smi line, one JSON line of per-kernel
results, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
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


def check(name: str, case: str, got, ref, tol: float) -> float:
    err, rel = rel_max_err(got, ref)
    ok = math.isfinite(rel) and rel <= tol
    log(f"[c] {case:12s} {name:4s} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version ({case})")
    return err


def phase_c(flash, rope_mod, peak, cases=CASES, dev="cuda"):
    """Each kernel against its plain version; returns per-kernel results at
    the main shapes."""
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
                            rope_mod.rope_plain(q, cos, sin), TOL["rope"])
        err["rope_bwd"] = check("rope", case + "-bwd", rope_mod.rope_cuda(do, cos, sin, True),
                                rope_mod.rope_plain(do, cos, sin, True), TOL["rope"])
        causal = c["causal"]
        o, lse = flash.flash_forward_cuda(q, k, v, causal)
        po, plse = flash.flash_forward_plain(q, k, v, causal)
        err["o"] = check("o", case, o, po, TOL["o"])
        err["lse"] = check("lse", case, lse, plse, TOL["lse"])
        for tag, cot in (("", None), ("+dlse", dlse)):
            delta = flash.flash_delta(do, o, cot)
            dq = flash.flash_dq_cuda(q, k, v, do, lse, delta, causal)
            pdq = flash.flash_dq_plain(q, k, v, do, lse, delta, causal)
            dk, dv = flash.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
            pdk, pdv = flash.flash_dkv_plain(q, k, v, do, lse, delta, causal)
            err["dq" + tag] = check("dq", case + tag, dq, pdq, TOL["dq"])
            err["dk" + tag] = check("dk", case + tag, dk, pdk, TOL["dk"])
            err["dv" + tag] = check("dv", case + tag, dv, pdv, TOL["dv"])
        if case != "main":
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
            log(f"[c] {name}: {res['ms']:.4f} ms, {res['bound_ms'] / res['ms']:.3f} of its "
                f"bound (plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
                f"{res['bound_by']}, library {res['library_ms']}) bytes {nbytes} flops {flops}")
            results[name] = res
        rope = work["rope"][0]
        log(f"[c] rope by events over back-to-back calls {time_ms(rope):.4f} ms; host cost "
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


def phase_e(build, peak):
    """llama-400m through the llama_train entry point, counters around it."""
    from tf_operator_tpu_torch.train import llama_train

    args = llama_train.parse_args(["--model", "llama-400m", "--batch", "8", "--seq", "2048",
                                   "--steps", "4", "--log-every", "1"])
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = llama_train.run(args)
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses, secs = out["losses"], out["step_seconds"]
    timed = secs[1:]
    tps = out["tokens_per_step"] * len(timed) / sum(timed)
    mfu = tps * out["config"].flops_per_token(args.seq) / (peak.bf16_tflops * 1e12)
    log(f"[e] losses {losses}")
    log(f"[e] step seconds {secs} (first is warm-up)")
    log(f"[e] tokens/s {tps:.1f} MFU {mfu:.4f} (peak {peak.bf16_tflops} TFLOP/s); "
        f"peak device memory {peak_gib:.2f} GiB")
    log(f"[e] launches in {len(secs)} steps {launches} (per step with per-block remat: "
        "rope 144, flash_fwd 48, flash_dq 24, flash_dkv 24)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    if abs(losses[0] - math.log(out["config"].vocab_size)) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is far from ln(vocab)")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches, len(secs)


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
    launches, steps = phase_e(build, peak)
    for name, res in results.items():
        res["launches"] = launches[name]
        res["launches_per_step"] = launches[name] / steps

    log(smi_line())
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
