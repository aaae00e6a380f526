"""The port's span recorder (``ospo_tpu_torch/utils/profiling.py``) on the
CPU: nesting, parents and unit ids across threads, the ring's bound, the
per-name totals, the process summary's ``spans`` key, spans in a
``torch.profiler`` trace, and the spans that ``run_step3``, ``run_scoring``
and ``SimPOTrainer.fit`` record on the tiny random-init model; and the
hand-written kernels' launch table beside it, against the launch sites
under ``ospo_tpu_torch/ops/`` (an AST scan)."""

import ast
import glob
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ospo_tpu_torch.config import Config
from ospo_tpu_torch.utils import profiling
from ospo_tpu_torch.utils.png import write_png
from ospo_tpu_torch.utils.profiling import SpanRecorder, span, span_totals, spans

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


def test_nesting_sets_parent_and_root():
    t0 = time.perf_counter()
    with span("t.outer", rows=3) as a:
        with span("t.middle") as b:
            with span("t.inner") as c:
                pass
        with span("t.second") as d:
            pass
    got = spans(t0, time.perf_counter())
    assert [s.name for s in got] == ["t.outer", "t.middle", "t.inner", "t.second"]
    assert (a.parent, a.root) == (None, a.id)
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (a.id, a.id)
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start <= d.end <= a.end
    assert a.attrs == {"rows": 3} and c.device_s is None
    with span("t.after") as e:
        pass
    assert e.parent is None and e.root == e.id   # the stack emptied


def test_a_unit_carries_its_id_to_other_threads():
    """``parent=`` joins work on another thread to the unit; spans nested
    there follow it; a span opened there without one is a root."""
    seen = {}

    def work(unit):
        with span("t.handed", parent=unit) as h:
            with span("t.handed_inner") as hi:
                pass
        with span("t.own") as own:
            pass
        seen.update(h=h, hi=hi, own=own)

    t0 = time.perf_counter()
    unit = span("t.unit")          # made before it opens, handed out first
    th = threading.Thread(target=work, args=(unit,))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    with unit:
        with span("t.local") as local:
            pass
    h, hi, own = seen["h"], seen["hi"], seen["own"]
    assert (h.parent, h.root) == (unit.id, unit.id)
    assert (hi.parent, hi.root) == (h.id, unit.id)
    assert (own.parent, own.root) == (None, own.id)
    assert local.root == unit.id and unit.root == unit.id
    assert h.thread != unit.thread and h.thread == own.thread
    assert {s.name for s in spans(t0, time.perf_counter())} >= {
        "t.unit", "t.local", "t.handed", "t.handed_inner", "t.own"}


def test_the_ring_is_bounded_and_the_totals_count_everything(monkeypatch):
    rec = SpanRecorder(capacity=4)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    made = []
    for i in range(10):
        with span("t.ring", rows=2, rows_used=i, label="x") as s:
            pass
        made.append(s)
    with span("t.device", device=True) as dev:
        time.sleep(0.002)
    assert [s.id for s in rec.ring] == [s.id for s in made[-3:]] + [dev.id]
    assert [s.id for s in rec.spans()] == [s.id for s in rec.ring]
    tot = rec.totals()
    assert tot["t.ring"]["count"] == 10
    assert tot["t.ring"]["rows"] == 20 and tot["t.ring"]["rows_used"] == 45
    assert "label" not in tot["t.ring"] and "device_s" not in tot["t.ring"]
    assert tot["t.ring"]["host_s"] == pytest.approx(sum(s.host_s for s in made))
    # without CUDA a device span's device time is its host time
    assert dev.device_s == dev.host_s >= 0.002
    assert tot["t.device"] == {"count": 1, "host_s": pytest.approx(dev.host_s),
                               "device_s": pytest.approx(dev.host_s)}


def test_threads_lose_no_update(monkeypatch):
    """Eight threads close spans of one name at a short switch interval:
    the totals count every one."""
    rec = SpanRecorder(capacity=64)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    n_threads, n_spans = 8, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with span("t.stress", rows=1):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    tot = rec.totals()["t.stress"]
    assert tot["count"] == tot["rows"] == n_threads * n_spans
    assert len(rec.ring) == 64


def test_the_process_summary_carries_the_totals(capsys):
    with span("t.summary", rows_run=5):
        pass
    profiling.print_process_summary("stagex", {"images": 2})
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("# stagex process 0/1: ")
    got = json.loads(line.split(": ", 1)[1])
    assert got["images"] == 2 and "launches" in got
    assert got["spans"]["t.summary"]["count"] >= 1
    assert got["spans"]["t.summary"]["rows_run"] >= 5
    assert set(got["spans"]) <= set(span_totals())


def test_spans_stand_in_the_profiler_trace_around_their_ops(tmp_path):
    """Under ``torch.profiler`` (CPU activity) each span is a
    ``user_annotation`` whose interval holds its aten ops."""
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("t.prof_outer"):
            with span("t.prof_inner"):
                torch.mm(x, x)
            torch.add(x, 1.0)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"t.prof_outer", "t.prof_inner"} <= set(ann)

    def inside(op, name):
        a = ann[name]
        return any(e["name"] == op and e.get("cat") == "cpu_op" and e["tid"] == a["tid"]
                   and a["ts"] <= e["ts"] and e["ts"] + e["dur"] <= a["ts"] + a["dur"]
                   for e in events)

    assert inside("aten::mm", "t.prof_inner") and inside("aten::mm", "t.prof_outer")
    assert inside("aten::add", "t.prof_outer") and not inside("aten::add", "t.prof_inner")
    with span("t.no_profiler") as s:   # no profiler: no annotation is entered
        assert s._annotation is None


# ---------------------------------------------------------------------------
# the pipeline's spans, tiny random-init model on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, processor = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cpu"}))
    return model, processor


def _by_root(got, root_name):
    roots = [s for s in got if s.name == root_name]
    return roots, {r.id: [s for s in got if s.root == r.id and s is not r] for r in roots}


def test_run_step3_records_a_group_by_part(tiny, tmp_path):
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine
    from ospo_tpu_torch.pipeline.step3 import run_step3

    model, processor = tiny
    engine = ImageGenEngine(model, processor, image_token_num=model.cfg.num_gen_tokens,
                            img_size=model.cfg.gen_image_size,
                            patch_size=model.cfg.vq.downsample_factor, decode_segments=2)
    n_img = engine.image_token_num
    items = [{"item_id": f"i{k}", "category": "object",
              "long_prompt": [f"a red cube {k}", "", f"two blue balls {k}"],
              "negative_long_prompt": ["", "", ""]} for k in range(2)]
    config = Config.from_nested({"batch_size": 2, "seed_list": [1, 2, 3],
                                 "save_path": str(tmp_path / "s3")})
    t0 = time.perf_counter()
    stats = run_step3(config, engine, processor, items)
    got = spans(t0, time.perf_counter())
    groups, inside = _by_root(got, "step3.group")
    assert stats["groups"] == len(groups) == 2
    for g in groups:
        assert g.attrs == {"pairs": 2}
        names = [s.name for s in inside[g.id]]
        assert names.count("image.prefill") == 1 and names.count("image.vq_decode") == 1
        assert names.count("image.trunk") == n_img - 1
        assert names.count("image.sample") == n_img
        writes = [s for s in inside[g.id] if s.name == "step3.png_write"]
        assert len(writes) == 1 and writes[0].thread != g.thread
        assert writes[0].parent == g.id
        vq = next(s for s in inside[g.id] if s.name == "image.vq_decode")
        assert vq.device_s == vq.host_s
        for s in inside[g.id]:
            if s.name.startswith("image."):
                assert g.start <= s.start <= s.end <= g.end
    assert [s.name for s in got].count("step3.png_wait") >= 1


def _png_tree(root, items, rng):
    for it in items:
        for kind, n in (("base", 2), ("negative", 1)):
            d = os.path.join(root, kind, it["category"], it["item_id"])
            os.makedirs(d)
            for j in range(n):
                write_png(os.path.join(d, f"{j:02d}.png"),
                          rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))


def test_run_scoring_counts_the_suffix_rows(tiny, tmp_path):
    """Mixed question counts, chunks of 4 with a ragged last one: the
    suffix spans' rows run and used equal a hand count."""
    from ospo_tpu_torch.engine.scoring import ScoringEngine
    from ospo_tpu_torch.pipeline.step4 import run_scoring

    model, processor = tiny
    counts = [2, 5, 3]
    items = [{"item_id": f"q{k}", "category": "object", "sub_category": "object",
              "prompt": f"a cube {k}",
              "question": [f"Is it blue {k} {i}?" for i in range(n - 1)]
              + [f"This image is generated by a prompt: a cube {k}. Does it match?"]}
             for k, n in enumerate(counts)]
    _png_tree(str(tmp_path / "img"), items, np.random.default_rng(0))
    config = Config.from_nested({"image_path": str(tmp_path / "img"), "score_rows": 4,
                                 "save_path": str(tmp_path / "out")})
    t0 = time.perf_counter()
    run_scoring(config, ScoringEngine(model, processor), items)
    got = spans(t0, time.perf_counter())

    # by hand: 3 images an item, sorted by count, chunks of 4, the last
    # padded with its last image; a chunk runs max(count) rows an image
    per_image = sorted(n for n in counts for _ in range(3))
    chunks = [per_image[i:i + 4] for i in range(0, len(per_image), 4)]
    run = sum(4 * max(c) for c in chunks)
    used = sum(sum(c + [c[-1]] * (4 - len(c))) for c in chunks)
    assert (run, used) == (52, 45)
    sfx = [s for s in got if s.name == "scoring.suffix"]
    assert sum(s.attrs["rows_run"] for s in sfx) == run
    assert sum(s.attrs["rows_used"] for s in sfx) == used

    units, inside = _by_root(got, "step4.chunk")
    assert [u.attrs["images"] for u in units] == [4, 4, 1]
    for u in units:
        names = [s.name for s in inside[u.id]]
        assert names.count("step4.prep_wait") == 1 and names.count("step4.prepare") == 1
        for part in ("upload", "vit", "prefill", "suffix", "readback"):
            assert f"scoring.{part}" in names
        prep = next(s for s in inside[u.id] if s.name == "step4.prepare")
        assert prep.thread != u.thread and prep.parent == u.id


def test_fit_records_one_update_with_its_phases(tiny, tmp_path):
    from ospo_tpu_torch.pipeline.datasets import PreferenceDataset
    from ospo_tpu_torch.train.trainer import SimPOTrainer

    model, processor = tiny
    rng = np.random.default_rng(1)
    records = []
    for i in range(4):
        paths = []
        for j in range(2):
            paths.append(str(tmp_path / f"{i}_{j}.png"))
            write_png(paths[-1], rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
        records.append({"item_id": str(i), "prompt": f"a photo of object {i}",
                        "chosen": paths[0], "rejected": paths[1]})
    (tmp_path / "train.json").write_text(json.dumps(records))
    trainer = SimPOTrainer(Config.from_nested({
        "lora": {"lora_rank": 4, "lora_alpha": 8, "lora_dropout": 0.0},
        "experiment": {"max_training_steps": 2, "log_steps": 1},
        "base": {"save_path": str(tmp_path / "ckpt"), "exp_name": "spans"}}),
        model, processor)
    dataset = PreferenceDataset(seed=0, data_path=str(tmp_path / "train.json"),
                                processor=processor)
    t0 = time.perf_counter()
    trainer.fit(dataset, batch_size=2)
    got = spans(t0, time.perf_counter())
    updates, inside = _by_root(got, "train.update")
    assert trainer.global_step == len(updates) == 2
    phases = ["train.vq_encode", "train.forward", "train.backward", "train.optimizer"]
    for u in updates:
        assert u.attrs == {"pairs": 2}
        assert [s.name for s in inside[u.id]] == phases
        for s in inside[u.id]:
            assert s.parent == u.id and u.start <= s.start <= s.end <= u.end
            assert s.device_s == s.host_s


# ---------------------------------------------------------------------------
# the kernels' launch table
# ---------------------------------------------------------------------------

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "ospo_tpu_torch")
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
           "int4_matmul_row", "int4_matmul_group", "moe_route", "moe_align",
           "moe_gate_up", "moe_down", "moe_combine", "w8a16_matmul",
           "suffix_attention", "gdn_decode", "add_rms_norm", "rope_kv_write",
           "silu_mul", "kda_decode")


def _trees(package):
    for path in sorted(glob.glob(os.path.join(PORT, package, "*.py"))):
        with open(path) as f:
            yield os.path.basename(path), ast.parse(f.read(), path)


def _literals(arg):
    """The kernel names a ``count_launch`` argument can take: a string or a
    choice of strings; anything else is None (no name the scan can read)."""
    if isinstance(arg, ast.IfExp):
        return _literals(arg.body) + _literals(arg.orelse)
    return [arg.value if isinstance(arg, ast.Constant) else None]


def _launch_sites():
    return [(module, name) for module, tree in _trees("ops")
            for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == "count_launch"
            for name in _literals(node.args[0])]


@pytest.mark.parametrize("kernel", KERNELS)
def test_launch_table_matches_the_kernels(kernel):
    """The table holds the seventeen kernels, and each has exactly one launch
    site under ``ops/``."""
    assert tuple(profiling.kernel_launches()) == KERNELS
    assert [name for _, name in _launch_sites()].count(kernel) == 1


def test_ops_count_only_the_tables_kernels():
    """Every ``count_launch`` under ``ops/`` names a kernel of the table,
    and no ``ops`` module keeps a launch counter of its own."""
    assert {name for _, name in _launch_sites()} == set(KERNELS)
    for module, tree in _trees("ops"):
        names = [t.id for node in tree.body if isinstance(node, (ast.Assign, ast.AnnAssign))
                 for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
                 if isinstance(t, ast.Name)]
        assert not [n for n in names if n.endswith("launches")], module


def test_utils_import_nothing_from_ops():
    """The bottom layer does not reach up: no module under ``utils/``
    imports ``ospo_tpu_torch.ops``, directly or by ``import_module``."""
    for module, tree in _trees("utils"):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and getattr(node.func, "attr", None) == "import_module":
                names = [str(node.args[0].value)]
            else:
                continue
            assert not [n for n in names if n.startswith("ospo_tpu_torch.ops")], module


@pytest.mark.parametrize("counter", ["count_launch", "add_kernel_launches"])
def test_count_launch_refuses_an_unknown_kernel(counter):
    """An unknown name raises from either function and changes no count,
    the known name beside it in the same call included."""
    before = profiling.kernel_launches()
    with pytest.raises(KeyError, match="flash_fwd_v2"):
        if counter == "count_launch":
            profiling.count_launch("flash_fwd_v2")
        else:
            profiling.add_kernel_launches({"flash_fwd": 1, "flash_fwd_v2": 1})
    assert profiling.kernel_launches() == before


def test_a_capture_takes_back_its_launches_and_a_replay_adds_them():
    """A CUDA graph's accounting, as ``_TrunkGraph`` keeps it: the launches
    counted while capturing are taken back, each replay adds them, and
    ``kernel_launches()`` is a copy a caller cannot change the table
    through."""
    before = profiling.kernel_launches()
    for name in ("decode_attention", "w8a16_matmul", "w8a16_matmul"):  # the capture
        profiling.count_launch(name)
    captured = {k: n - before[k] for k, n in profiling.kernel_launches().items()
                if n != before[k]}
    assert captured == {"decode_attention": 1, "w8a16_matmul": 2}
    profiling.add_kernel_launches({k: -n for k, n in captured.items()})
    assert profiling.kernel_launches() == before
    for _ in range(3):                                              # replays
        profiling.add_kernel_launches(captured)
    got = profiling.kernel_launches()
    assert {k: got[k] - before[k] for k in captured} == {"decode_attention": 3,
                                                         "w8a16_matmul": 6}
    got["flash_fwd"] += 1000
    assert profiling.kernel_launches()["flash_fwd"] == before["flash_fwd"]
    profiling.add_kernel_launches({k: -3 * n for k, n in captured.items()})
    assert profiling.kernel_launches() == before
