"""The harness's pieces on the CPU: the manifest and the files it names, the
batch cutter, the pass order, the import check and the device-trace
reduction."""

import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import compare, devtrace, harness
from portbench.corpus import make_tree

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["shape"] in ("kernel", "config")
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]).read)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    assert all(m["moves"] in reported for m in c.per_layer)


def test_manifest_keeps_to_the_contract():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    configs = {c["name"] for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(len(layer) <= 200 for layer in layers)
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_a_new_config_traffic_and_metric_are_new_files_only(tmp_path):
    """A later change adds a cell as files and one manifest entry; the
    harness's own files stay as they are."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("_cache", "_out", "__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    (bench / "configs" / "secret-extra.json").write_text(json.dumps(
        {"name": "secret-extra", "engine": {"backend": "hybrid"}, "reduced": []}))
    extra = {**json.loads((BENCH / "traffic" / "config-tree.json").read_text()),
             "n_files": 120, "planted_every": 10}
    (bench / "traffic" / "tiny-tree.json").write_text(json.dumps(extra))
    (bench / "metrics" / "files_seen.py").write_text(
        "def on_batch(run, engine):\n    run.state['seen'] = run.state.get('seen', 0) + 1\n\n"
        "def read(run):\n    return run.state.get('seen')\n")
    manifest["workloads"].append({"name": "extra.tiny", "config": "secret-extra",
                                  "traffic": "tiny-tree", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "files_seen", "unit": "batches", "better": "higher",
                                  "source": "program_counter", "layer": "client",
                                  "moves": "files_per_s", "workloads": ["extra.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell("extra.tiny", root=tmp_path, bench=bench)
    assert cell.config["engine"] == {"backend": "hybrid"}
    assert [m["name"] for m in cell.per_layer] == ["files_seen"]
    mod = harness.reader("files_seen", bench=bench)
    run = SimpleNamespace(state={})
    mod.on_batch(run, None)
    assert mod.read(run) == 1
    tree = make_tree(cell.traffic, 7)
    assert len(tree) == 120
    for name in ("harness.py", "run.py", "corpus.py", "compare.py", "devtrace.py"):
        assert (bench / name).read_bytes() == (BENCH / name).read_bytes()


def test_batch_cutter_matches_the_runners_256_mib_cuts():
    from trivy_tpu_torch.analyzer.core import BIG_ENTRY_BYTES, MAX_BATCH_BYTES, _byte_bounded

    sizes = [3 << 20] * 100 + [200 << 20, 100 << 20, 60 << 20, 1, 256 << 20, 5] + [7 << 20] * 50
    entries = [SimpleNamespace(size=s) for s in sizes]
    pos = {id(e): i for i, e in enumerate(entries)}
    want = [[pos[id(e)] for e in g] for g in _byte_bounded(entries, MAX_BATCH_BYTES)]
    traffic = json.loads((BENCH / "traffic" / "config-tree.json").read_text())
    assert traffic["batch_max_bytes"] == MAX_BATCH_BYTES
    assert traffic["big_file_bytes"] == BIG_ENTRY_BYTES
    got = harness.byte_bounded(sizes, traffic["batch_max_bytes"], traffic["big_file_bytes"])
    assert got == want and len(got) > 5


def test_every_pass_sends_every_file_once_from_a_new_start():
    traffic = {"pass_offset_stride": 0.6180339887498949, "batch_max_bytes": 10_000,
               "big_file_bytes": 5_000}
    sizes = [100 + (i * 37) % 900 for i in range(1000)]
    starts = set()
    for p in range(40):
        batches = harness.pass_batches(sizes, traffic, p)
        flat = [i for b in batches for i in b]
        assert sorted(flat) == list(range(1000))
        assert all(sum(sizes[i] for i in b) <= 10_000 for b in batches)
        starts.add(flat[0])
    assert len(starts) == 40


def test_import_check_compares_whole_top_level_names():
    modules = {"trivy_tpu.engine": 1, "jax": 1, "jaxlib.xla": 1, "trivy_tpu_torch.engine": 1,
               "trivy_tpu_torch": 1, "jaxtyping": 1, "flaxen": 1}
    assert compare.loaded(harness.FORBIDDEN, modules) == ["jax", "jaxlib.xla", "trivy_tpu.engine"]


def _trace(tmp_path, kernels, marks=((0, 100), (100, 100))):
    events = [{"ph": "X", "cat": "user_annotation", "name": devtrace.ANNOTATION,
               "ts": 1000 + a, "dur": d} for a, d in marks]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": 1000 + a, "dur": d}
               for cat, name, a, d in kernels]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_device_trace_reduction(tmp_path):
    kernels = [("kernel", "gram_sieve_kernel(unsigned char const*, int)", 10, 20),
               ("kernel", "gram_sieve_kernel(unsigned char const*, int)", 20, 20),
               ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 120, 30),
               ("kernel", "void at::native::fill_kernel()", 300, 10)]
    spans = [SimpleNamespace(name="confirm", start=0.000150, dur=0.000050, tid=1),
             SimpleNamespace(name="sieve", start=0.000160, dur=0.000030, tid=2)]
    got = devtrace.reduce_trace(_trace(tmp_path, kernels), [0.0, 0.0001], spans, 2,
                                {"gram_sieve_kernel", "nfa_stream_kernel"}, 0.0002, main_tid=1)
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["busy_s"] == pytest.approx(60e-6)  # 10..40 and 120..150, inside the window
    assert got["kernel_s"] == pytest.approx(40e-6) and got["program_kernels"] == 2
    assert got["device_ops"][0] == ("gram_sieve_kernel(unsigned char const*, int)",
                                    pytest.approx(40e-6))
    gaps = dict(got["idle_gaps"])
    assert gaps["confirm"] == pytest.approx(50e-6)  # 150..200: the main thread's confirm
    assert gaps["outside spans"] == pytest.approx(90e-6)  # 0..10, 40..120
    # a long gap is cut where spans open and close
    spans = [SimpleNamespace(name="verify", start=0.000045, dur=0.000020, tid=1),
             SimpleNamespace(name="confirm", start=0.000070, dur=0.000030, tid=1)]
    got = devtrace.reduce_trace(_trace(tmp_path, kernels), [0.0, 0.0001], spans, 2,
                                {"gram_sieve_kernel"}, 0.0002, main_tid=1)
    gaps = dict(got["idle_gaps"])
    assert gaps["verify"] == pytest.approx(20e-6) and gaps["confirm"] == pytest.approx(30e-6)
    assert gaps["outside spans"] == pytest.approx(10e-6 + 5e-6 + 5e-6 + 20e-6 + 50e-6)
    with pytest.raises(RuntimeError, match="records were lost"):
        devtrace.reduce_trace(_trace(tmp_path, kernels), [0.0, 0.0001], [], 3,
                              {"gram_sieve_kernel"}, 0.0002)
    with pytest.raises(RuntimeError, match="exceeds the CUDA events"):
        devtrace.reduce_trace(_trace(tmp_path, kernels), [0.0, 0.0001], [], 2,
                              {"gram_sieve_kernel"}, 0.00001)


def test_program_kernel_names_come_from_the_sources():
    import trivy_tpu_torch

    names = devtrace.program_kernel_names(Path(trivy_tpu_torch.__file__).parent / "csrc")
    assert {"gram_sieve_kernel", "nfa_stream_kernel", "mega_count_kernel"} <= names
