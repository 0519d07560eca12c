"""The port's workload generators against the reference, on the CPU.

Each of the four scenarios re-recorded through the port (``hwsw``, the
reference's recording kind) and given the expect blocks of all seven kinds
must serialise byte for byte to its committed tape. The recorder's slot
refs, its EPOCH_RESET rule, its JSON round trip, and the hash-table
workload are held to the reference's live recorder on the same streams;
a recording on ``fused`` must give the same request arrays as on
``hwsw``. The tolerance is exact equality throughout.
"""
import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as jheap
from repro.workloads import hashtable as jht
from repro.workloads import trace as jtrace

from repro_torch.core import heap
from repro_torch.workloads import hashtable, record, replay, scenarios, trace

TAPES = Path(__file__).resolve().parents[1] / "benchmarks" / "tapes"
NAMES = ("graph_churn", "kv_paged", "hashtable", "decode_serve")
ARRAYS = ("op", "size", "ptr_ref", "ptr_raw")


def tape_bytes(tape) -> str:
    return json.dumps(tape.to_json(), indent=1) + "\n"


@pytest.mark.parametrize("name", NAMES)
def test_scenario_rerecords_its_committed_tape_byte_for_byte(name):
    tape = scenarios.SCENARIOS[name](smoke=True, device="cpu")
    replay.attach_expectations(tape, device="cpu")
    assert tape_bytes(tape) == (TAPES / f"{name}.json").read_text()


def test_expect_blocks_in_registration_order_fail_the_byte_comparison():
    """The repaired key order: `attach_expectations` inserts the blocks
    sorted by the reference's kind name; inserted in the port's
    registration order (``fused`` last, the order before the repair) the
    same blocks serialise to other bytes."""
    want = (TAPES / "decode_serve.json").read_text()
    tape = trace.Trace.load(str(TAPES / "decode_serve.json"))
    replay.attach_expectations(tape, device="cpu")
    assert list(tape.expect) == sorted(tape.expect)
    assert tape_bytes(tape) == want
    old = copy.deepcopy(tape)
    old.expect = {replay.EXPECT_KEY.get(k, k):
                  tape.expect[replay.EXPECT_KEY.get(k, k)]
                  for k in heap.kinds()}
    assert old.expect == tape.expect          # the same blocks ...
    assert tape_bytes(old) != want            # ... in another order


def test_recorder_slot_refs_and_json_round_trip_match_reference(tmp_path):
    ref = jtrace.RecordingAllocator(heap_bytes=1 << 19, num_threads=4,
                                    kind="hwsw")
    r0 = ref.request(jheap.malloc_request(
        jnp.array([16, 100, 2048, 8192], jnp.int32)))
    ref.request(jheap.realloc_request(
        r0.ptr, jnp.array([300, 100, 0, 16384], jnp.int32)))
    ref.request(jheap.free_request(
        jnp.array([-1, int(r0.ptr[1]), -1, -1], jnp.int32)))
    want = ref.finish("tiny", "unit", meta={"x": 1})

    rec = trace.RecordingAllocator(heap_bytes=1 << 19, num_threads=4,
                                   kind="hwsw", device="cpu")
    p0 = rec.request(heap.malloc_request(torch.tensor([16, 100, 2048,
                                                       8192])))
    rec.request(heap.realloc_request(p0.ptr, torch.tensor([300, 100, 0,
                                                           16384])))
    rec.request(heap.free_request(torch.tensor([-1, int(p0.ptr[1]), -1,
                                                -1])))
    assert rec.recorded_rounds == 3
    got = rec.finish("tiny", "unit", meta={"x": 1})
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.ptr_ref[1, 0] == 0 and got.ptr_ref[2, 1] == 1 * 4 + 1
    assert got.ptr_ref[2, 0] == -1 and got.op[2, 0] == heap.OP_NOOP
    assert got.to_json() == want.to_json()
    path = tmp_path / "t.json"
    got.save(str(path))
    want.save(str(tmp_path / "want.json"))
    assert path.read_bytes() == (tmp_path / "want.json").read_bytes()
    back = trace.Trace.load(str(path))
    assert back.meta == {"x": 1, "max_size_class": 2048}
    assert back.to_json() == got.to_json()


def test_recorder_epoch_reset_rule_matches_reference():
    """An EPOCH_RESET retires every small pointer at round start: a later
    free through one records ptr_ref -1 (raw), a big one keeps its ref."""
    def stream(mod, rec, arr, reset):
        r0 = rec.request(mod.malloc_request(arr([16, 4096, 64, 0])))
        rec.request(reset)
        rec.request(mod.free_request(arr([int(r0.ptr[0]), int(r0.ptr[1]),
                                          int(r0.ptr[2]), -1])))
        return rec.finish("epoch", "unit")

    want = stream(jheap, jtrace.RecordingAllocator(
        heap_bytes=1 << 19, num_threads=4, kind="arena"),
        lambda x: jnp.array(x, jnp.int32),
        jheap.epoch_reset_request(4, active=jnp.array([1, 0, 0, 0]) > 0))
    got = stream(heap, trace.RecordingAllocator(
        heap_bytes=1 << 19, num_threads=4, kind="arena", device="cpu"),
        lambda x: torch.tensor(x, dtype=torch.int32),
        heap.epoch_reset_request(4, active=torch.tensor([1, 0, 0, 0]) > 0,
                                 device="cpu"))
    assert got.ptr_ref[2].tolist() == [-1, 1, -1, -1]
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_recorder_rejects_multicore_rounds_and_lints():
    rec = trace.RecordingAllocator(heap_bytes=1 << 19, num_threads=4,
                                   kind="sw", device="cpu")
    with pytest.raises(ValueError, match=r"single-core \[T\]"):
        rec.request(heap.malloc_request(torch.full((2, 4), 16)))
    p = rec.request(heap.malloc_request(torch.tensor([16, 0, 0, 0]))).ptr
    # two threads free one chain in one round: lint race-A
    rec.request(heap.free_request(torch.tensor([int(p[0]), int(p[0]), -1,
                                                -1])))
    with pytest.raises(ValueError, match="race-A"):
        rec.finish("racy")
    assert rec.finish("racy", lint=False).rounds == 2


def test_hashtable_workload_verifies_and_matches_reference():
    cfg = dict(num_threads=8, heap_bytes=1 << 19, n_inserts=24,
               delete_every=4, seed=5)
    ref = jtrace.RecordingAllocator(heap_bytes=1 << 19, num_threads=8,
                                    kind="sw")
    jwl = jht.HashTableWorkload(jht.HashTableConfig(**cfg), ref)
    jstats = jwl.run()
    rec = trace.RecordingAllocator(heap_bytes=1 << 19, num_threads=8,
                                   kind="sw", device="cpu")
    wl = hashtable.HashTableWorkload(hashtable.HashTableConfig(**cfg), rec)
    stats = wl.run()
    wl.verify()
    assert stats == jstats and stats["grow_rounds"] >= 1
    for a, b in zip(wl.tables, jwl.tables):
        assert (a.ptr, a.capacity, a.live) == (b.ptr, b.capacity, b.live)
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.vptr, b.vptr)
    got, want = rec.finish("ht", "unit"), ref.finish("ht", "unit")
    assert got.to_json() == want.to_json()
    wl.tables[1].vptr[wl.tables[1].keys != 0] = wl.tables[0].vptr[
        wl.tables[0].keys != 0][0]
    with pytest.raises(AssertionError):
        wl.verify()


def test_fused_recording_equals_hwsw_recording():
    """`fused` == `hwsw` in full: the same requests, so the same tape
    apart from `recorded_kind`."""
    a = scenarios.record_hashtable(kind="hwsw", device="cpu")
    b = scenarios.record_hashtable(kind="fused", device="cpu")
    assert (a.recorded_kind, b.recorded_kind) == ("hwsw", "fused")
    assert dict(a.to_json(), recorded_kind="fused") == b.to_json()


def test_record_cli_writes_outside_the_reference_tapes(tmp_path, capsys):
    assert record.main(["--out", str(tmp_path), "--device", "cpu",
                        "--scenarios", "decode_serve"]) == 0
    assert (tmp_path / "decode_serve.json").read_bytes() == \
        (TAPES / "decode_serve.json").read_bytes()
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        record.main(["--out", str(TAPES), "--device", "cpu"])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenarios.record_decode_serve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.RecordingAllocator(heap_bytes=1 << 19, num_threads=4)
