"""The port's tracer (utils/profiling.py) on the CPU, and the benchmark's
readers of it (asr_bench/metrics/*.py):

  * host spans nest under the right parents, a span inside one of its
    own name is the outer one, and each ``dispatch`` gets a number;
  * the span ring and the stamps' list drop their oldest entries and
    count the drops; `summary` reports the losses that may lie in its
    window, and no interval spans stamps lost on the card;
  * `summary` keeps only the spans and stamp intervals inside its window;
  * EagerSteps (the CPU's K-step dispatch) stamps forward, backward and
    update for each of its K steps, in order, inside its ``dispatch``
    span; the trainer's loop records ``data_wait``, ``dispatch`` and
    ``drain`` and logs their ms a step at the epoch's end;
  * under ``--trace-dir`` the spans are ranges of the profiler's trace;
  * each new reader returns None on a CPU run (the CPU's stamps are host
    marks) and on a record that lost stamps, and its value on a made-up
    record of the card; the benchmark lists the five for both train cells;
  * a stamp captured before its card's ring exists raises (on the card).

tests/test_torch_gpu.py holds the device stamps, the parts' sums and
the node counts of a captured graph on the card.
"""

import importlib.util
import json
import logging
import os

import pytest
import torch

from asr_bench import core
from end2end_asr_tpu_torch.config import Config, load_vocab
from end2end_asr_tpu_torch.data.dataset import ManifestDataset
from end2end_asr_tpu_torch.data.loader import AudioBatchLoader
from end2end_asr_tpu_torch.models.layers import DropoutRng
from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                      init_params)
from end2end_asr_tpu_torch.training import steps as TS
from end2end_asr_tpu_torch.training import trainer as TR
from end2end_asr_tpu_torch.training.optimizer import init_opt_state
from end2end_asr_tpu_torch.utils import profiling as P

from synth import make_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("aishell_vgg.train_k4", "aishell_lrt.train_k4")
# the readers of the tracer (asr_bench/metrics/<name>.py)
NEW = ("fwd_ms.train", "bwd_ms.train", "update_ms.train",
       "writeback_ms.train", "graph_nodes_per_step.train")
# the readers of the card's stamps
STAMPED = NEW[:-1]
K = 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the model is tiny, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spans_nest_under_their_parents():
    rec = P.Recorder()
    with rec.span("dispatch") as d:
        with rec.span("stage") as s:
            pass
        with rec.span("dispatch"):      # the trainer's around the call's
            with rec.span("launch") as la:
                pass
    with rec.span("drain") as dr:
        pass
    with rec.span("dispatch") as d2:
        pass
    got = {name: (sid, parent, n) for sid, name, _, _, parent, n
           in list(rec.spans)[:4]}
    assert got == {"stage": (s.id, d.id, 1), "launch": (la.id, d.id, 1),
                   "dispatch": (d.id, 0, 1), "drain": (dr.id, 0, 1)}
    sid, name, _, _, parent, n = rec.spans[-1]
    assert (sid, name, parent, n) == (d2.id, "dispatch", 0, 2)
    assert rec.dispatch == 2
    for _, _, a, b, parent, _ in rec.spans:
        assert a <= b
    # each span ends inside its parent
    by_id = {sid: (a, b) for sid, _, a, b, _, _ in rec.spans}
    for sid, _, a, b, parent, _ in rec.spans:
        if parent:
            assert by_id[parent][0] <= a and b <= by_id[parent][1]


def test_rings_drop_their_oldest_and_count_them():
    rec = P.Recorder(span_capacity=3, host_stamps=4)
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert [s[1] for s in rec.spans] == ["s2", "s3", "s4"]
    assert rec.lost["spans"][0] == 2
    for i in range(7):
        rec.stamp(f"m{i}", torch.device("cpu"))
    assert [s[0] for s in rec.stamps] == ["m3", "m4", "m5", "m6"]
    assert rec.lost["stamps"][0] == 3
    assert rec.summary()["lost"] == {"spans": 2, "stamps": 3}
    rec.clear()
    assert not rec.spans and not rec.stamps and not rec.lost
    assert rec.summary()["lost"] == {"spans": 0, "stamps": 0}


def test_summary_reports_the_losses_that_may_lie_in_its_window():
    """The lists lose their oldest entries first: a window that opens after
    the newest lost entry lost nothing, one that opens before it may have,
    and `card_window` refuses it."""
    rec = P.Recorder(span_capacity=2, host_stamps=3)
    for name, t in (("a", 1.0), ("b", 2.0), ("c", 3.0), ("d", 4.0),
                    ("e", 5.0)):
        rec._keep(name, t, 0)
    assert rec.lost["stamps"] == [2, 2.0]       # a and b, b at 2 s
    assert rec.summary(1.5, 9.0)["lost"]["stamps"] == 2
    assert rec.summary(2.0, 9.0)["lost"]["stamps"] == 2
    assert rec.summary(2.5, 9.0)["lost"] == {"spans": 0, "stamps": 0}
    assert rec.card_window(2.5, 9.0)["device_stamps"] == 3
    assert rec.card_window(1.5, 9.0) is None
    for name in ("x", "y", "z"):
        with rec.span(name):
            pass
    assert [s[1] for s in rec.spans] == ["y", "z"]
    y_start = rec.spans[0][2]
    assert rec.lost["spans"][0] == 1 and rec.lost["spans"][1] <= y_start
    assert rec.summary(y_start)["lost"]["spans"] == 0
    assert rec.summary()["lost"] == {"spans": 1, "stamps": 2}


def test_stamps_lost_on_the_card_leave_no_interval_across_them():
    """A device ring overwritten before its copy-out (`_break`, as
    `_Ring.collect` calls it): the stamps around the loss are not paired,
    the loss counts in the windows it may lie in, and `card_window`
    refuses those."""
    rec = P.Recorder()
    for name, t in ((P.STEP_START, 1.0), (P.FORWARD, 2.0)):
        rec._keep(name, t, 0)
    rec._break(0, 4.5, 3)                       # backward, update, ... lost
    for name, t in ((P.STEP_START, 4.5), (P.FORWARD, 5.0),
                    (P.BACKWARD, 6.0)):
        rec._keep(name, t, 0)
    parts = [(p, a, b) for p, a, b, _ in rec.intervals()]
    assert parts == [("forward", 1.0, 2.0), ("forward", 4.5, 5.0),
                     ("backward", 5.0, 6.0)]
    assert rec.summary(0.0, 9.0)["lost"]["stamps"] == 3
    assert rec.summary(0.0, 9.0)["device_stamps"] == 5
    assert rec.card_window(0.0, 9.0) is None
    assert rec.card_window(4.6, 9.0)["parts"] == {
        "backward": {"n": 1, "s": 1.0}}


def test_summary_clips_to_its_window():
    rec = P.Recorder()
    for name, a, b in (("dispatch", 1.0, 2.0), ("dispatch", 3.0, 4.0),
                       ("dispatch", 5.0, 6.5), ("launch", 3.2, 3.5)):
        rec.spans.append((0, name, a, b, 0, 0))
    for name, t in ((P.DISPATCH_START, 1.0), (P.STEP_START, 1.1),
                    (P.FORWARD, 1.5), (P.DISPATCH_END, 2.0),
                    (P.DISPATCH_START, 3.0), (P.STEP_START, 3.25),
                    (P.FORWARD, 3.5), (P.DISPATCH_END, 4.0),
                    (P.DISPATCH_START, 5.0)):
        rec._keep(name, t, 0)
    s = rec.summary(2.5, 4.5)
    assert s["spans"] == {"dispatch": {"n": 1, "s": 1.0},
                          "launch": {"n": 1, "s": pytest.approx(0.3)}}
    assert s["parts"] == {"stage": {"n": 1, "s": 0.25},
                          "forward": {"n": 1, "s": 0.25},
                          "outputs": {"n": 1, "s": 0.5}}
    assert s["device_stamps"] == 4
    whole = rec.summary()
    assert whole["parts"]["gap"] == {"n": 2, "s": 2.0}
    assert whole["spans"]["dispatch"]["n"] == 3


def _tiny_step():
    cfg = Config(feat_extractor="", num_layers=1, num_heads=2, dim_model=32,
                 dim_key=16, dim_value=16, dim_inner=64, dim_emb=32,
                 dropout=0.1, dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, 12, g)
    T = 40
    pcm = torch.randn(2, (T - 1) * cfg.hop_length + cfg.n_fft,
                      generator=g) * 0.2
    batch = (pcm, torch.tensor([T, T - 5]),
             torch.tensor([[1, 5, 6, 7, 2, 0], [1, 8, 9, 2, 0, 0]]),
             torch.tensor([5, 4]))
    fp = TS.FlatParams(params, torch.device("cpu"))
    step = TS.make_train_step_impl(cfg, dims_from_config(cfg))
    return cfg, fp, step, batch, T


def test_eager_steps_stamp_each_part_of_each_step_in_order():
    cfg, fp, step, batch, T = _tiny_step()
    multi = TS.make_multi_train_step(cfg, step, K, torch.device("cpu"))
    rng = DropoutRng(1, "cpu")
    data, opt = fp.data, init_opt_state(cfg, fp.data)
    data, opt, _, _, _, _ = step(fp, data, opt, rng, *batch, T)
    P.RECORDER.clear()
    multi(fp, data, opt, rng, [batch] * K, T)
    names = [s[0] for s in P.RECORDER.stamps]
    assert names == ([P.DISPATCH_START]
                     + [P.STEP_START, P.FORWARD, P.BACKWARD, P.UPDATE] * K
                     + [P.DISPATCH_END])
    parts = [p for p, _, _, key in P.RECORDER.intervals()]
    assert parts == (["stage"] + ["forward", "backward", "update",
                                  "between"] * K)[:-1] + ["outputs"]
    s = P.RECORDER.summary()
    assert s["device_stamps"] == 0
    assert {p: v["n"] for p, v in s["parts"].items()} == {
        "stage": 1, "forward": K, "backward": K, "update": K,
        "between": K - 1, "outputs": 1}
    assert s["spans"]["dispatch"]["n"] == 1
    assert s["spans"]["step"]["n"] == K
    steps = sum(s["parts"][p]["s"] for p in ("forward", "backward",
                                             "update"))
    assert 0 < steps <= s["spans"]["dispatch"]["s"]
    assert sum(v["s"] for v in s["parts"].values()) <= \
        s["spans"]["dispatch"]["s"]


def test_trainer_logs_the_loop_spans_a_step(tmp_path, caplog):
    manifest, labels = make_corpus(
        str(tmp_path / "c"), texts=["ab", "ba", "abba", "baab", "aabb",
                                    "bbaa", "abab", "baba"],
        exact_samples=63 * 160)
    cfg = Config(feat_extractor="", num_layers=1, num_heads=2, dim_model=32,
                 dim_key=16, dim_value=16, dim_inner=64, dim_emb=32,
                 batch_size=2, dropout=0.1, src_max_len=64, tgt_max_len=8,
                 src_buckets=(64,), tgt_buckets=(8,), dtype="float32",
                 epochs=1, save_every=100, seed=3,
                 save_folder=str(tmp_path / "m"), name="t",
                 steps_per_dispatch=K)
    label2id, id2label = load_vocab(labels)
    ds = ManifestDataset([manifest], label2id)
    params = init_params(cfg, len(label2id),
                         torch.Generator().manual_seed(cfg.seed))
    P.RECORDER.clear()
    caplog.set_level(logging.INFO, logger="end2end_asr_tpu_torch")
    TR.Trainer(cfg, label2id, id2label, torch.device("cpu")).train(
        params, None, AudioBatchLoader(ds, cfg), [], num_epochs=1)
    line, = [r.getMessage() for r in caplog.records
             if "TRACE" in r.getMessage()]
    assert line.startswith("(Epoch 1) TRACE host ms a step: ")
    for name in ("data_wait", "dispatch", "drain", "step"):
        assert f" {name} " in line.split(";")[0], line
    # the CPU's stamps are host marks: no device clock is claimed
    assert "; host ms a step: " in line and "device" not in line
    for part in ("forward", "backward", "update"):
        assert f" {part} " in line.split(";")[1], line
    # nothing of the epoch lost; the CPU's marks have no clocks to drift;
    # no CUDA graph captured, no update on a card
    assert line.endswith("; lost spans 0 stamps 0; clock drift 0.0 us; "
                         "graph launches a step: none; plain updates on "
                         "the card 0"), line
    # 4 batches: a group of 3 (one dispatch) and a single step
    assert P.RECORDER.summary()["spans"]["dispatch"]["n"] == 2
    assert P.RECORDER.summary()["spans"]["data_wait"]["n"] == 5


def test_trace_dir_spans_are_profiler_ranges(tmp_path):
    with P.trace(str(tmp_path), torch.device("cpu")):
        with P.RECORDER.span("dispatch"):
            with P.RECORDER.span("launch"):
                torch.ones(4).sum()
    assert not P.RECORDER.profiler_ranges
    path, = [p for p in tmp_path.iterdir() if p.name.endswith(".json")]
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"dispatch", "launch"} <= names


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"),
        os.path.join(ROOT, "asr_bench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_on_a_cpu_run(name, monkeypatch):
    rec = P.Recorder()
    monkeypatch.setattr(P, "RECORDER", rec)
    for t, stamp in enumerate((P.DISPATCH_START, P.STEP_START, P.FORWARD,
                               P.BACKWARD, P.UPDATE, P.DISPATCH_END)):
        rec._keep(stamp, 10.0 + t, "cpu")
    run = {"kind": "train", "steps": 4, "window": (0.0, 100.0)}
    assert _reader(name)(run) is None
    assert _reader(name)({**run, "kind": "serve"}) is None


def _card_run(rec, lose_at=None):
    """A made-up record of the card: three dispatches of 2 steps on device
    0 inside the window [0, 10] s, one before the window; stamps 1 ms apart
    unless noted. With `lose_at` (a stamp's number), 2 stamps are lost on
    the card before that one."""
    t = [0.0]
    n = [0]

    def stamp(name, dt=1e-3):
        t[0] += dt
        n[0] += 1
        if n[0] == lose_at:
            rec._break(0, t[0], 2)
        rec._keep(name, t[0], 0)

    t[0] = -1.0                          # a dispatch before the window
    stamp(P.DISPATCH_END)
    t[0] = 1.0
    for gap in (2e-3, 0.5, 1e-3):
        stamp(P.DISPATCH_START, gap)
        for _ in range(2):
            stamp(P.STEP_START)
            stamp(P.FORWARD, 3e-3)
            stamp(P.BACKWARD, 6e-3)
            stamp(P.UPDATE, 2e-3)
            stamp(P.WRITEBACK, 0.25e-3)
        stamp(P.DISPATCH_END)
    rec.graph("graphed_steps.1", (800,)).update(
        steps=2, kernel_nodes=2650, replays=7, stamps=10)
    rec.graph("graphed_steps.1", (400,)).update(
        steps=2, kernel_nodes=2000, replays=1, stamps=10)
    return {"kind": "train", "steps": 6, "window": (0.0, 10.0)}


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_a_made_up_card_record(name, monkeypatch):
    rec = P.Recorder()
    monkeypatch.setattr(P, "RECORDER", rec)
    run = _card_run(rec)
    # per step: the parts' ms; the graph replayed most: 2650 / 2
    want = {"fwd_ms.train": 3.0, "bwd_ms.train": 6.0, "update_ms.train": 2.0,
            "writeback_ms.train": 0.25, "graph_nodes_per_step.train": 1325.0}
    assert _reader(name)(run) == pytest.approx(want[name], rel=1e-6)


@pytest.mark.parametrize("name", STAMPED)
def test_reader_reads_nothing_where_the_card_lost_stamps(name, monkeypatch):
    """Stamps lost on the card inside the read window (before the last
    dispatch's first step): the parts would be short by them, so the
    readers of the stamps give None."""
    rec = P.Recorder()
    monkeypatch.setattr(P, "RECORDER", rec)
    assert _reader(name)(_card_run(rec, lose_at=27)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_from_a_program_without_the_tracer(
        name, monkeypatch):
    """The benchmark's readers over a checkout of the program from before
    the tracer: `profiling` has no RECORDER, and each reader gives None."""
    run = _card_run(P.Recorder())
    monkeypatch.delattr(P, "RECORDER")
    assert _reader(name)(run) is None


def test_benchmark_lists_the_tracer_readers_for_both_cells():
    bench = core.benchmark()
    for cell in CELLS:
        names = {m["name"] for m in core.metrics_of(bench, cell, True)}
        assert set(NEW) <= names, cell
        assert not set(NEW) & {m["name"] for m in
                               core.metrics_of(bench, cell, False)}
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["moves"] == "train_utt_per_s"
            assert os.path.exists(os.path.join(
                ROOT, "asr_bench", "metrics", m["name"] + ".py"))
