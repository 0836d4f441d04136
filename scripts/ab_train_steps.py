"""Training throughput of two checkouts of the repo, in alternating pairs.

    python3 scripts/ab_train_steps.py PARENT_DIR CHANGE_DIR [--pairs 10]
        [--steps 12] [--model llama-400m] [--batch 8] [--seq 2048]

Runs the port's entry point (``python -m
tf_operator_tpu_torch.train.llama_train``) from each checkout in turn, one
process a run, ``--pairs`` times each, after building each checkout's
kernels; the side that runs first alternates from pair to pair. Each run
logs only its first and its last step (``--log-every`` the step count),
so that no step between waits for the card on a log line; each line
carries the cumulative tokens/s since the loop began, from which the time
to the end of that step follows, and a run's figure is the tokens/s of
the window between the two lines: the first step (allocator and library
warm-up) is left out. Prints every run, then each side's median and quartiles,
the pairs the change won, and whether the difference is resolved: the
change wins at least nine tenths of the pairs and the medians differ by
more than the distance between the parent's quartiles. The last line is
one JSON object of the same numbers. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

STEP = re.compile(r"^\[llama\] step (\d+) loss (\S+) tokens/sec ([\d,]+)", re.M)


def run_once(tree: str, args: argparse.Namespace) -> dict:
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train",
           "--model", args.model, "--batch", str(args.batch), "--seq", str(args.seq),
           "--steps", str(args.steps), "--log-every", str(args.steps)]
    out = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stdout}{out.stderr}")
    tokens = args.batch * args.seq
    lines = STEP.findall(out.stdout)
    if [int(k) for k, _, _ in lines] != [0, args.steps - 1]:
        raise RuntimeError(f"{tree}: step lines {lines}, expected steps 0 and "
                           f"{args.steps - 1}\n{out.stdout}")
    # Step k's cumulative tokens/s is (k + 1) * tokens over the time since
    # the loop began, so (k + 1) * tokens / tps is the time to its end.
    first, last = ((int(k) + 1) * tokens / float(tps.replace(",", "")) for k, _, tps in lines)
    window = last - first
    return {"tokens_per_s": tokens * (args.steps - 1) / window,
            "step_s": window / (args.steps - 1),
            "losses": [float(loss) for _, loss, _ in lines]}


def quartiles(xs: list[float]) -> tuple[float, float, float]:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return q1, q2, q3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("--model", default="llama-400m")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=2048)
    args = parser.parse_args(argv)

    for tree in (args.parent, args.change):  # so that no run's first step builds them
        subprocess.run([sys.executable, "-c", "from tf_operator_tpu_torch.ops import build; "
                        "build.load()"], cwd=tree, check=True, timeout=900)
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            r = run_once(getattr(args, side), args)
            runs[side].append(r)
            print(f"pair {i} {side}: {r['tokens_per_s']:.1f} tokens/s, step "
                  f"{r['step_s']:.4f} s, first and last losses {r['losses']}", flush=True)

    tps = {side: [r["tokens_per_s"] for r in rs] for side, rs in runs.items()}
    wins = sum(c > p for p, c in zip(tps["parent"], tps["change"]))
    losses_ = sum(c < p for p, c in zip(tps["parent"], tps["change"]))
    q = {side: quartiles(v) for side, v in tps.items()}
    spread = q["parent"][2] - q["parent"][0]
    gain = q["change"][1] - q["parent"][1]
    if wins >= 0.9 * args.pairs and gain > spread:
        verdict = "change faster, resolved"
    elif losses_ >= 0.9 * args.pairs and -gain > spread:
        verdict = "change slower, resolved"
    else:
        verdict = "unresolved"
    for side in ("parent", "change"):
        print(f"{side}: tokens/s median {q[side][1]:.1f}, quartiles {q[side][0]:.1f} - "
              f"{q[side][2]:.1f}")
    print(f"change won {wins} of {args.pairs} pairs (lost {losses_}); medians differ by "
          f"{gain:.1f} tokens/s against the parent's quartile spread {spread:.1f}: {verdict}")
    print(json.dumps({"pairs": args.pairs, "steps": args.steps, "tokens_per_s": tps,
                      "quartiles": q, "wins": wins, "losses": losses_,
                      "verdict": verdict}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
