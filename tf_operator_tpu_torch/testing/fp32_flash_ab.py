"""The fp32 flash kernels and the fp32 llama-400m step of checkouts of the
repo, in turns on one card.

    python3 -m tf_operator_tpu_torch.testing.fp32_flash_ab PARENT_DIR CHANGE_DIR
        [--ablate] [--out FILE]

Runs, from each checkout's root and in its own process (its own kernels,
built there first): the fp32 forward, dQ and dK/dV kernels timed at
[8, 2048, 8, D] causal for D = 64, 128 and 256 (chip_smoke.time_ms, CUDA
events), SDPA's fp32 forward on the same inputs, and llama-400m in fp32
through chip_smoke.train_run (bs 8, seq 2048, "dots", 1 warm-up step and
3 timed: step time, tokens/s, MFU, peak memory, launches a step). The
order is parent, change, change, parent, so that a drift of the card's
clocks falls on both sides; each side's figures are the mean of its two
runs. With ``--ablate``, a copy of CHANGE_DIR's tree is made under its
``_archive/`` (ignored by git) for each entry of ABLATIONS, with one part
of the 3xTF32 kernels changed, and timed after the four runs, without the
step: "no_split" (the forward's producer neither splits K nor writes V^T:
what its splitting passes cost), "one_pass" (one hi x hi product a k8 step
instead of three, in every 3xTF32 kernel: what the passes cost) and
"no_softmax" (the forward's consumer skips the online softmax), whose
results are wrong and only their times mean anything; "truncated_hi"
(every natural tile's split leaves x in place as its own, truncated, hi
and writes lo = x - trunc(x) beside it, as before hi was rounded in
place: what the rounding costs) and "dq_narrow_tiles" (dQ on tiles of
32 keys at width 64 and 16 at 128, with two A and two T slots: the other
tiling its header weighs), whose results are right. Prints
each run as one JSON line and, last, a JSON object of the sides' means;
``--out`` writes it too. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

RUN = r'''
import dataclasses, json, sys, torch
import chip_smoke as cs
from tf_operator_tpu_torch.device import peak_for, tflops_for
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.ops import build, flash

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.load()
peak, _ = peak_for(torch.cuda.get_device_name(0))
rate = tflops_for(peak, torch.float32) * 1e12
gen = torch.Generator(device="cuda").manual_seed(0)
out = {"kernels": {}}
for d in (64, 128, 256):
    q, k, v, do, dlse = cs.case_inputs(dict(cs.MAIN, d=d), gen, dtype=torch.float32)
    o, lse = flash.flash_forward_cuda(q, k, v, True)
    delta = flash.flash_delta(do, o)
    work = flash.flash_work(8, 2048, 2048, 8, 8, d, True, 4)
    row = {"fwd_ms": cs.time_ms(lambda: flash.flash_forward_cuda(q, k, v, True)),
           "dq_ms": cs.time_ms(lambda: flash.flash_dq_cuda(q, k, v, do, lse, delta, True)),
           "dkv_ms": cs.time_ms(lambda: flash.flash_dkv_cuda(q, k, v, do, lse, delta, True)),
           "sdpa_fwd_ms": cs.time_ms(lambda: cs.sdpa(q, k, v, True))}
    for name in ("fwd", "dq", "dkv"):
        row[name + "_bound_ms"] = work["flash_" + name][1] / rate * 1e3
    out["kernels"][d] = row
    del q, k, v, do, dlse, o, lse, delta
if "--step" in sys.argv:
    cfg = dataclasses.replace(llama.CONFIGS["llama-400m"], dtype=torch.float32,
                              param_dtype=torch.float32)
    run = cs.train_run(build, peak, "ab", [*cs.MAIN_ARGS, "--steps", "4"], config=cfg)
    out.update({key: run[key] for key in ("step_s", "tokens_per_s", "mfu", "peak_gib")})
    out["launches_per_step"] = {k: n for k, n in run["per_step"].items() if n}
out["card"] = cs.smi_line()
print(json.dumps(out))
'''

# Ablations of the 3xTF32 kernels: (file, text, replacement).
ABLATIONS = {
    "no_split": [
        ("flash_fwd_f32.cu", "      split_natural<L::kTile>(a, a + L::kTile, tid);\n", ""),
        ("flash_fwd_f32.cu",
         "      transpose_split<kN, kD>(a + 2 * L::kTile, smem + L::kOffT + t * L::kSlotT, tid);\n",
         ""),
    ],
    "one_pass": [
        ("tf32x3.cuh", "    mma_rs(acc, &l[4 * kk], hi);\n    mma_rs(acc, &h[4 * kk], lo);\n", ""),
        ("tf32x3.cuh",
         "    mma_ss(d, kmajor_desc(a_lo + ao), kmajor_desc(b + bo), kk);\n"
         "    mma_ss(d, kmajor_desc(a + ao), kmajor_desc(b_lo + bo), 1);\n"
         "    mma_ss(d, kmajor_desc(a + ao), kmajor_desc(b + bo), 1);",
         "    mma_ss(d, kmajor_desc(a + ao), kmajor_desc(b + bo), kk);"),
    ],
    "no_softmax": [
        ("flash_fwd_f32.cu",
         "    softmax_step(sc, m0, m1, l0, l1, alpha0, alpha1, masked, k0, row0, cq, Sk, causal, "
         "c);\n",
         "    alpha0 = alpha1 = l0 = l1 = 1.0f;\n    m0 = m1 = 0.0f;\n    (void)masked;\n"),
    ],
    "truncated_hi": [
        ("tf32x3.cuh",
         "    const float4 h = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), "
         "tf32_hi(v.w));\n    xs[i] = h;\n",
         "    const float4 h = make_float4(\n"
         "        __uint_as_float(__float_as_uint(v.x) & 0xFFFFE000u),\n"
         "        __uint_as_float(__float_as_uint(v.y) & 0xFFFFE000u),\n"
         "        __uint_as_float(__float_as_uint(v.z) & 0xFFFFE000u),\n"
         "        __uint_as_float(__float_as_uint(v.w) & 0xFFFFE000u));\n"),
    ],
    "dq_narrow_tiles": [
        ("flash_dq_f32.cu",
         "  static constexpr int kN = kD == 64 ? 64 : 32;  // keys of a K/V tile\n"
         "  static constexpr int kSlotsA = kD == 64 ? 2 : 1;\n  static constexpr int kSlotsT = 1;\n",
         "  static constexpr int kN = kD == 64 ? 32 : 16;  // keys of a K/V tile\n"
         "  static constexpr int kSlotsA = 2;\n  static constexpr int kSlotsT = 2;\n"),
    ],
}


def ablated_tree(change: str, name: str) -> str:
    """A copy of ``change``'s package and chip_smoke.py under its
    ``_archive/ablate_<name>``, with ABLATIONS[name] applied."""
    root = os.path.join(change, "_archive", f"ablate_{name}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shutil.copytree(os.path.join(change, "tf_operator_tpu_torch"),
                    os.path.join(root, "tf_operator_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(change, "chip_smoke.py"), root)
    csrc = os.path.join(root, "tf_operator_tpu_torch", "ops", "csrc")
    for fname, old, new in ABLATIONS[name]:
        path = os.path.join(csrc, fname)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"ablation {name}: {fname} no longer holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    return root


def run(tree: str, step: bool) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, *(["--step"] if step else [])], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stdout}{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def mean_of(runs: list) -> dict:
    first = runs[0]
    res = {"kernels": {d: {key: statistics.mean(r["kernels"][d][key] for r in runs)
                           for key in first["kernels"][d]} for d in first["kernels"]}}
    for key in ("step_s", "tokens_per_s", "mfu", "peak_gib"):
        if key in first:
            res[key] = statistics.mean(r[key] for r in runs)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    runs = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        res = run(trees[side], step=True)
        print(json.dumps({"side": side, **res}), flush=True)
        runs[side].append(res)
    summary = {side: mean_of(r) for side, r in runs.items()}
    if args.ablate:
        for name in ABLATIONS:
            res = run(ablated_tree(trees["change"], name), step=False)
            print(json.dumps({"side": name, **res}), flush=True)
            summary[name] = res
    summary["card"] = runs["change"][0]["card"]
    text = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
