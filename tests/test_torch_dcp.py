"""Sharded checkpoints of the port (``--checkpoint-format orbax``:
`<base>.dcp/` through torch.distributed.checkpoint, training/checkpoint.py),
in one spawn of gloo ranks on the CPU for the module.

The ranks (tests/torch_tp_worker.py, no JAX) run the train entry point:
at world 2, --mesh-model 2 --fsdp in both formats, full rank and at
--model LRTRFS (whose factors every rank holds whole); at world 4, --mesh-data
2 --mesh-model 2 --zero1 in both formats, each resumed at another layout
(--mesh-data 4 --fsdp), and --auto-resume of the sharded run. The tests
assert on the files: each rank wrote only the pieces it holds; a sharded
save loads in one process equal to the npz of the same run; a resume at
another layout equals the npz's resume; --auto-resume finds `.dcp`
bases; `test` in one process on a sharded save prints the npz's strings.
"""

import json
import logging
import os
import re
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from end2end_asr_tpu_torch import test as port_test
from end2end_asr_tpu_torch.training import checkpoint as TC

import torch_tp_worker as W
from synth import make_corpus
from test_torch_parallel import TEXTS, load
from test_torch_tp import LR_ARGS, _model_argv

WORLD = 4
GROUP_TIMEOUT_S = 600
DCP = ["--checkpoint-format", "orbax"]
Z1 = ["--parallel", "--mesh-data", "2", "--mesh-model", "2", "--zero1"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dcp"))
    corpus = make_corpus(os.path.join(root, "corpus"), texts=TEXTS)
    train = _model_argv(corpus, root) + ["--device", "cpu"]
    ck = lambda name: os.path.join(root, "models", name, "epoch_1")
    resume = ["--parallel", "--fsdp", "--epochs", "2"]
    entry = {
        "2": [{"name": f"fsdp{lr}_{f}", "train": train + [
            "--name", f"fsdp{lr}_{f}", "--parallel", "--mesh-model", "2",
            "--fsdp", *extra, *lr_args]}
            for lr, lr_args in (("", []), ("_lr", LR_ARGS))
            for f, extra in (("dcp", DCP), ("npz", []))],
        "4": [*({"name": "z1_" + f, "train": train + [
                   "--name", "z1_" + f, *Z1, *extra]}
                for f, extra in (("dcp", DCP), ("npz", []))),
              *({"name": "resume_" + f, "train": train + [
                   "--name", "resume_" + f, "--continue-from", ck("z1_" + f),
                   *resume]} for f in ("dcp", "npz")),
              {"name": "auto", "train": train + [
                  "--name", "z1_dcp", "--auto-resume", "--epochs", "2",
                  *Z1, *DCP]}]}
    spec = {"steps": {"2": {}, "4": {}}, "entry": entry}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    ctx = mp.spawn(W.run, args=(WORLD, root), nprocs=WORLD, join=False)
    deadline = time.time() + GROUP_TIMEOUT_S
    while not ctx.join(timeout=5):     # a rank's exception raises here
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"the {WORLD}-rank group ran over "
                        f"{GROUP_TIMEOUT_S} s")
    return root, corpus


def _base(root, name, epoch=1):
    return os.path.join(root, "models", name, f"epoch_{epoch}")


def _flat_ckpt(base):
    _, epoch, params, opt, state, _, _, _ = TC.load_checkpoint(base)
    flat = {"params::" + k: v for k, v in TC.flatten_params(params).items()}
    flat.update({"opt::" + k: v for k, v in TC.flatten_params(opt).items()})
    return epoch, flat


def test_each_rank_writes_only_the_pieces_it_holds(group):
    """2 x 2 with ZeRO-1: the moments' slices are the rank's own keys and
    files; a model coordinate's parameters, which its two data ranks
    both hold, are written once, by one of them; nothing is gathered (no
    piece is larger than a coordinate's buffer)."""
    import torch.distributed.checkpoint as dcp
    root = group[0]
    base = _base(root, "z1_dcp")
    assert os.path.isdir(base + ".dcp") and not os.path.exists(base + ".npz")
    with open(base + ".json") as f:
        layout = json.load(f)["dcp"]
    assert (layout["n_data"], layout["n_model"], layout["stage"]) == (2, 2, 1)
    md = dcp.FileSystemReader(base + ".dcp").read_metadata()
    writer = {}
    for idx, info in md.storage_data.items():
        rank = int(re.match(r"__(\d+)_", info.relative_path).group(1))
        writer.setdefault(idx.fqn, set()).add(rank)
    full = sum(int(np.prod(s)) for s in layout["shapes"].values())
    for key, ranks in writer.items():
        assert len(ranks) == 1, key
        rank = ranks.pop()
        m = re.search(r"::m(\d)(?:::d(\d))?$", key)
        if m:
            d_rank, m_rank = divmod(rank, 2)
            assert int(m.group(1)) == m_rank, key
            if m.group(2) is not None:
                assert int(m.group(2)) == d_rank, key
            assert md.state_dict_metadata[key].size[0] < full, key
    assert {k for k in writer if k.startswith("mu::")} == {
        f"mu::m{m}::d{d}" for m in range(2) for d in range(2)}
    assert {k for k in writer if k.startswith("params::")} == {
        "params::m0", "params::m1"}


@pytest.mark.parametrize("name", ["z1", "fsdp", "fsdp_lr"])
def test_sharded_save_loads_in_one_process_equal_to_the_npz(group, name):
    root = group[0]
    e1, a = _flat_ckpt(_base(root, name + "_dcp"))
    e2, b = _flat_ckpt(_base(root, name + "_npz"))
    assert e1 == e2 == 1 and set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # and what the ranks returned is what was saved
    got = load(root, name + "_dcp")
    for k, v in got.items():
        np.testing.assert_array_equal(a["params::" + k].numpy(), v)


def test_resume_at_another_layout_equals_the_npz_resume(group):
    """Both checkpoints of the 2 x 2 --zero1 run resumed at --mesh-data 4
    --fsdp for a second epoch: the same parameters, bit for bit."""
    root = group[0]
    a, b = load(root, "resume_dcp"), load(root, "resume_npz")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    e, flat = _flat_ckpt(_base(root, "resume_dcp", 2))
    assert e == 2 and int(flat["opt::step"]) == 4


def test_auto_resume_finds_the_sharded_checkpoint(group):
    root = group[0]
    assert TC.find_latest_checkpoint(os.path.join(root, "models"),
                                     "z1_dcp") == _base(root, "z1_dcp", 2)
    e, flat = _flat_ckpt(_base(root, "z1_dcp", 2))
    assert e == 2 and int(flat["opt::step"]) == 4
    got = load(root, "auto")
    want = load(root, "resume_dcp")
    for k in got:       # the same second epoch, at another layout
        d = np.abs(got[k] - want[k])
        assert d.max() < 1e-2 and (d <= 1e-5).mean() >= 0.99, k


def test_one_process_test_on_the_sharded_save_prints_the_npz_strings(
        group):
    """The --mesh-model 2 --fsdp run's two checkpoints served by `test` in
    one process, with no group: the same strings."""
    root, corpus = group
    out = []
    for f in ("dcp", "npz"):
        lines = []
        handler = logging.Handler()
        handler.emit = lambda r, lines=lines: lines.append(r.getMessage())
        log = logging.getLogger("end2end_asr_tpu_torch")
        log.addHandler(handler)
        level = log.level
        log.setLevel(logging.INFO)
        try:
            res = port_test.main([
                "--continue-from", _base(root, "fsdp_" + f),
                "--test-manifest-list", corpus[0], "--batch-size", "4",
                "--device", "cpu", "--verbose"])
        finally:
            log.removeHandler(handler)
            log.setLevel(level)
        out.append(([ln for ln in lines if ln.startswith("HYP: ")],
                    res["cer"]))
    assert len(out[0][0]) == len(TEXTS)
    assert out[0] == out[1]


def test_a_jax_orbax_directory_is_refused(tmp_path):
    base = str(tmp_path / "ck")
    os.makedirs(base + ".orbax")
    with open(base + ".json", "w") as f:
        json.dump({}, f)
    with pytest.raises(NotImplementedError, match="orbax imports jax"):
        TC.load_checkpoint(base)
