#!/usr/bin/env python3
"""Show that chip_smoke phase 16 (c) fails when the sequence-parallel
decode is wrong, at its bf16 token gate and at its fp32 slice.

    python3 tools/seqpar_mutants.py --work DIR [--out F]

Runs on the CPU (no card, no nvcc), in 2-4 minutes. Phase 16 (c) holds
the decode on a ("data"=1, "model"=2) mesh of processes against the
one-device decode: the greedy tokens must be equal wherever the
one-device top-2 gap is at least SEQPAR_BF16_GAP of max |logit|, and a
2-layer fp32 slice must agree within SEQPAR_FP32_TOL of max |logit|. This
script copies ``src/`` and ``chip_smoke.py`` into DIR/<name>/ (the
checkout is only read), once sound and once for each broken
`kvcache.paged.write_attend_seqpar`:

  drop_partial  the SUM all-reduce of the denominators and outputs leaves
                the second process's partial out;
  wrong_owner   the new token is written by the process that does not
                own its page, and not by the one that does;
  local_max     the row maxima are not MAX-reduced over "model": each
                process exponentiates against its own.

Each copy runs phase 16 whole (`chip_smoke.phase_mesh`) at a reduced
size, every process on the CPU over gloo: granite-3-8b's reduced config
(2 layers, width 128) in bf16, 2 x 32 prompt tokens and 4 decode steps,
the fp32 slice at 2 x 32 tokens and 4 steps, (a) and (b) on a 4 x 2 x 16
fleet for 12 rounds. A mutant runs twice: as it is, where (c) must fail
at the token gate; then with the gate's errors read but not raised, where
(c) must fail at the fp32 slice, whose error is read.

Prints one JSON line per copy and exits non-zero unless the sound copy
passes and every mutant fails at both.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAGED = Path("src/repro_torch/kvcache/paged.py")

# name -> (text of the sound source, its replacement)
MUTANTS = {
    "drop_partial": (
        "    lo = comm.all_reduce(torch.cat([p.sum(dim=-1)[..., None], o_p], "
        "dim=-1),\n                         group=group)\n",
        "    part = torch.cat([p.sum(dim=-1)[..., None], o_p], dim=-1)\n"
        "    if dist.get_rank(group) == 1:\n"
        "        part = torch.zeros_like(part)\n"
        "    lo = comm.all_reduce(part, group=group)\n"),
    "wrong_owner": (
        "    mine = ((pidx >= base) & (pidx < base + Pl))[:, None, None]\n",
        "    mine = ~((pidx >= base) & (pidx < base + Pl))[:, None, None]\n"),
    "local_max": (
        "    m = comm.all_reduce(s.amax(dim=-1), dist.ReduceOp.MAX, "
        "group=group)\n",
        "    m = s.amax(dim=-1)\n"),
}

# appended to each copy's chip_smoke.py: phase 16 at the reduced size, on
# the CPU (spawn re-imports the module in every process, so this applies
# there too)
REDUCED = '''

import dataclasses as _dc
import torch as _torch
from repro_torch import configs as _configs
_get = _configs.get
_configs.get = lambda name: _dc.replace(_get(name).reduced(),
                                        dtype="bfloat16")
SERVE_FLEET = ((4, 2, 16), dict(seed=17, rounds=24, num_tenants=128,
                                queue_cap=256))
STEADY_ROUNDS, SNAP_ROUND = 12, 12
MESH_SHARDS, MESH_SHARD_ROUNDS = ((8, 1), (2, 4)), 1
SERVE_BATCH, SERVE_PROMPT, SEQPAR_STEPS = 2, 32, 4
SEQPAR_CHECK = (2, 2, 32, 4)


def mesh_device():
    return _torch.device("cpu")
'''

RUNNER = '''import json, os, sys
sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
import torch
import chip_smoke


def main(read_gate):
    out = dict(gate=[])
    if read_gate:
        check = chip_smoke.near_tie_errors

        def read(*a, **kw):
            errs, diff = check(*a, **kw)
            out["gate"] += errs
            return [], diff
        chip_smoke.near_tie_errors = read
    try:
        res = chip_smoke.phase_mesh(0, torch.device("cpu"), "cpu")["decode"]
        out.update(passed=True, fp32_err=res["fp32_err"],
                   fed_diff=len(res["forced_diff"]),
                   near_ties=len(res["near_ties"]))
    except AssertionError as e:
        out.update(passed=False, error=str(e))
    print("RESULT " + json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1] == "read_gate")
'''


def run(d: Path, mode: str) -> dict:
    p = subprocess.run([sys.executable, "run_phase16.py", mode], cwd=d,
                       capture_output=True, text=True, timeout=900)
    lines = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
    if p.returncode or not lines:
        raise RuntimeError(f"{d.name} {mode}: exit {p.returncode}\n"
                           f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def fp32_error(msg: str):
    m = re.search(r"\(c\) fp32: max \|mesh - one device\| / max \|logit\| = "
                  r"([0-9.e+-]+)", msg)
    return float(m.group(1)) if m else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True,
                    help="directory for the copies (made anew)")
    ap.add_argument("--out", default=None, help="also write the JSON lines")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    tol = chip_smoke.SEQPAR_FP32_TOL
    work = Path(args.work).resolve()
    rows, ok = [], True
    for name, change in [("sound", None), *MUTANTS.items()]:
        d = work / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "src", d / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (d / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text() + REDUCED)
        (d / "run_phase16.py").write_text(RUNNER)
        if change:
            text = (d / PAGED).read_text()
            if text.count(change[0]) != 1:
                raise RuntimeError(f"{name}: the sound text is not in "
                                   f"{PAGED} once")
            (d / PAGED).write_text(text.replace(*change))
        first = run(d, "as_is")
        row = dict(copy=name, passed=first["passed"],
                   error=first.get("error", "")[:300])
        if change is None:
            row.update(fp32_err=first.get("fp32_err"),
                       fed_diff=first.get("fed_diff"),
                       near_ties=first.get("near_ties"))
            good = first["passed"] and first["fp32_err"] <= tol
        else:
            second = run(d, "read_gate")
            err = fp32_error(second.get("error", ""))
            row.update(gate_errors=len(second["gate"]), fp32_err=err)
            good = (not first["passed"]
                    and first["error"].startswith("(c) process")
                    and "top-2 gap" in first["error"]
                    and len(second["gate"]) > 0
                    and err is not None and err > tol)
        row["as_expected"] = good
        ok &= good
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(f"seqpar mutants: {'every check as expected' if ok else 'FAILED'}"
          f" (fp32 limit {tol}, token gate {chip_smoke.SEQPAR_BF16_GAP})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
