#!/usr/bin/env python3
"""Show that the gates of training on a mesh catch planted faults: the CPU
test (tests/test_torch_mesh_train.py) and chip_smoke phase 17.

    python3 tools/mesh_train_mutants.py --work DIR [--out F]

Runs on the CPU (no card), in 4-6 minutes. Copies ``src/``, ``tests/``,
``pyproject.toml`` and ``chip_smoke.py`` into DIR/<name>/ (the checkout is
only read), once sound and once for each fault:

  same_rows          `shard_batch` gives every process the rows of the
                     first data position;
  no_data_reduction  a gradient's pending sum over the data axes is left
                     out where the port reduces it (the accumulator's add
                     and the optimizer's placement): each data position
                     updates with its own rows' partial gradient (the
                     weights replicated over "data"; an FSDP weight's
                     gradient is reduce-scattered by `layers.at_use`);
  psum_drop_rank     `compressed_psum` leaves the first process's payload
                     out of the sum.

In each copy it runs the test file (pytest; the reference's subprocess
included) and phase 17 whole (`chip_smoke.phase_mesh_train`) at a reduced
size, every process on the CPU over gloo: granite-3-8b's reduced config
(2 layers, width 128) in bf16 at 4 x 32 tokens, the fp32 guard at 1 layer,
compressed_psum over 4096 elements. The sound copy must pass both; every
fault must fail both. Prints one JSON line per copy and exits non-zero
otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TESTS = ("conftest.py", "test_torch_mesh_train.py",
         "torch_mesh_train_workers.py", "torch_mesh_train_reference.py")
LOCAL_SUM = '''

def _local_sum(g):
    """(planted fault) a partial sum over the data axes taken as whole"""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    names = g.device_mesh.mesh_dim_names
    pl = [Replicate() if isinstance(p, Partial) and names[i] != "model"
          else p for i, p in enumerate(g.placements)]
    return DTensor.from_local(g.to_local(), g.device_mesh, pl,
                              run_check=False)
'''

# name -> [(file, text of the sound source, its replacement)]; a file's
# text appended where the replacement is None
MUTANTS = {
    "same_rows": [(
        "src/repro_torch/data/pipeline.py",
        "        out[k] = placed[k].place(torch.from_numpy(v), device=dev)\n",
        "        v = np.concatenate([v[:v.shape[0] // dp]] * dp)\n"
        "        out[k] = placed[k].place(torch.from_numpy(v), device=dev)\n")],
    "no_data_reduction": [
        ("src/repro_torch/launch/steps.py",
         "                    b = b.float().redistribute(a.device_mesh, "
         "a.placements)\n",
         "                    b = _local_sum(b.float()).redistribute(\n"
         "                        a.device_mesh, a.placements)\n"),
        ("src/repro_torch/launch/steps.py", None, LOCAL_SUM),
        ("src/repro_torch/optim/adamw.py",
         "    return g.redistribute(p.device_mesh, p.placements)\n",
         "    return _local_sum(g).redistribute(p.device_mesh, "
         "p.placements)\n"),
        ("src/repro_torch/optim/adamw.py", None, LOCAL_SUM)],
    "psum_drop_rank": [(
        "src/repro_torch/optim/compression.py",
        '    total = torch.einsum("pb,pbk->bk", scales, qs.float())\n',
        '    total = torch.einsum("pb,pbk->bk", scales[1:], '
        'qs[1:].float())\n')],
}

# appended to each copy's chip_smoke.py: phase 17 at the reduced size, on
# the CPU (spawn re-imports the module in every process, so this applies
# there too)
REDUCED = '''

import dataclasses as _dc
import torch as _torch
from repro_torch import configs as _configs
_get = _configs.get
_configs.get = lambda name: _dc.replace(_get(name).reduced(),
                                        dtype="bfloat16")
MT_BATCH, MT_SEQ = 4, 32
MT_FP32 = (1, 4, 32, 1)
MT_PSUM_N = 4096


def mesh_device():
    _torch.set_num_threads(1)
    return _torch.device("cpu")
'''

RUNNER = '''import json, os, sys
sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
import torch
import chip_smoke

if __name__ == "__main__":
    try:
        res = chip_smoke.phase_mesh_train(0, torch.device("cpu"), "cpu")
        out = dict(passed=True, worst=res["worst"], psum_err=res["psum_err"])
    except AssertionError as e:
        out = dict(passed=False, error=str(e))
    print("RESULT " + json.dumps(out))
'''


def phase17(d: Path) -> dict:
    p = subprocess.run([sys.executable, "run_phase17.py"], cwd=d,
                       capture_output=True, text=True, timeout=900)
    lines = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
    if p.returncode or not lines:
        raise RuntimeError(f"{d.name} phase 17: exit {p.returncode}\n"
                           f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def cpu_test(d: Path) -> dict:
    env = dict(os.environ, PYTHONPATH="src",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                        "no:cacheprovider", "-p", "no:randomly",
                        "tests/test_torch_mesh_train.py"], cwd=d, env=env,
                       capture_output=True, text=True, timeout=900)
    failed = sorted({x.split("::")[1].split(" ")[0] for x in
                     p.stdout.splitlines() if x.startswith("FAILED ")})
    return dict(rc=p.returncode, failed=failed,
                summary=(p.stdout.strip().splitlines() or [""])[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True,
                    help="directory for the copies (made anew)")
    ap.add_argument("--out", default=None, help="also write the JSON lines")
    args = ap.parse_args(argv)
    work = Path(args.work).resolve()
    rows, ok = [], True
    for name, changes in [("sound", []), *MUTANTS.items()]:
        d = work / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "src", d / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (d / "tests").mkdir()
        for f in TESTS:
            shutil.copy(ROOT / "tests" / f, d / "tests" / f)
        shutil.copy(ROOT / "pyproject.toml", d / "pyproject.toml")
        (d / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text() + REDUCED)
        (d / "run_phase17.py").write_text(RUNNER)
        for path, old, new in changes:
            text = (d / path).read_text()
            if old is None:
                text += new
            elif text.count(old) != 1:
                raise RuntimeError(f"{name}: the sound text is not in "
                                   f"{path} once")
            else:
                text = text.replace(old, new)
            (d / path).write_text(text)
        gate = phase17(d)
        test = cpu_test(d)
        row = dict(copy=name, phase17_passed=gate["passed"],
                   phase17_error=gate.get("error", "")[:400],
                   cpu_test_rc=test["rc"], cpu_test_failed=test["failed"],
                   cpu_test_summary=test["summary"])
        if not changes:
            row.update(worst=gate.get("worst"), psum_err=gate.get("psum_err"))
            good = gate["passed"] and test["rc"] == 0
        else:
            good = not gate["passed"] and test["rc"] != 0
        row["as_expected"] = good
        ok &= good
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(f"mesh train mutants: "
          f"{'every check as expected' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
