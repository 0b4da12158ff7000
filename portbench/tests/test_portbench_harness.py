"""The harness's pieces on the CPU: the manifest and the files it names, a
configuration with its own entry, reference and shape added as new files,
the generator's trees, the batch cutter, the pass order, the import check
and the device-trace reduction."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import compare, corpus, devtrace, harness
from portbench.corpus import make_tree

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert callable(corpus.shape(c.traffic["shape"]))
    ent = harness.entry(c.config)
    assert all(callable(getattr(ent, f)) for f in ("build", "scan", "keep", "answer"))
    assert callable(compare.reference_module(c.config).answers)
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


# A configuration the harness has never seen, as a later change would add
# it: a trivy-secret.yaml with a custom rule that names a secret group, a
# disabled builtin rule and a custom allow rule; an entry that builds the
# engine from it; a plain reference that applies it to the builtin rules; a
# rules file of what to plant (the custom rule and the disabled one, which
# the yaml can only name); a shape that plants them and tokens the allow
# rule lets pass.
CUSTOM_YAML = """\
rules:
  - id: internal-token
    category: Internal
    title: Internal service token
    severity: HIGH
    regex: 'token = "(?P<secret>itk_[a-z0-9]{24})"'
    secret-group-name: secret
    keywords:
      - itk_
disable-rules:
  - github-pat
allow-rules:
  - id: internal-test-token
    description: tokens of the test service
    regex: itk_0000
"""

CUSTOM_PLANTED = {"rules": [
    {"id": "internal-token", "category": "Internal", "severity": "HIGH",
     "title": "Internal service token", "regex": 'token = "(?P<secret>itk_[a-z0-9]{24})"',
     "secret-group-name": "secret", "keywords": ["itk_"]},
    {"id": "github-pat", "category": "GitHub", "severity": "CRITICAL",
     "title": "GitHub Personal Access Token", "regex": "ghp_[0-9a-zA-Z]{36}",
     "keywords": ["ghp_"]}]}

CUSTOM_ENTRY = """\
from pathlib import Path

from portbench.entries.secret import answer, keep, scan  # noqa: F401
from trivy_tpu_torch.engine.hybrid import make_secret_engine
from trivy_tpu_torch.rules.model import load_config

BENCH = Path(__file__).resolve().parents[1]


def build(config, device, rules_cache_dir):
    secret_config = load_config(str(BENCH / config["secret_config"]))
    {break_it}
    engine = make_secret_engine(device=device, rules_cache_dir=str(rules_cache_dir),
                                config=secret_config, **config["engine"])
    engine.warmup()
    return engine
"""

CUSTOM_REFERENCE = """\
import json
from pathlib import Path

import yaml

from portbench.reference.secret_scan import RULES_FILE, SecretScanner

BENCH = Path(__file__).resolve().parents[1]


def answers(config, items, control=False):
    builtin = json.loads(RULES_FILE.read_text())
    raw = yaml.safe_load((BENCH / config["secret_config"]).read_text()) or {}
    enabled = raw.get("enable-builtin-rules") or []
    rules = [r for r in builtin["rules"] if not enabled or r["id"] in enabled]
    rules = [r for r in rules + (raw.get("rules") or [])
             if r["id"] not in (raw.get("disable-rules") or [])]
    allow = [a for a in builtin["allow-rules"] + (raw.get("allow-rules") or [])
             if a.get("id") not in (raw.get("disable-allow-rules") or [])]
    doc = {"rules": rules, "allow-rules": allow, "exclude-block": raw.get("exclude-block")}
    scanner = SecretScanner(doc, secret_group_spans=not control)
    return [scanner.scan(path, content) for path, content in items]
"""

CUSTOM_SHAPE = """\
import numpy as np

from portbench.corpus import planted_rules, planted_secret


def make(traffic, seed, stop):
    rng = np.random.default_rng([int(seed), 5])
    rules_file = planted_rules(traffic)
    every, allowed = int(traffic["planted_every"]), int(traffic["allowed_every"])
    out = []
    for i in range(stop):
        lines = [b"name = service%d\\n" % i, b"replicas = 3\\n"]
        if i % every == 0:
            lines.insert(1, planted_secret(rng, i // every, rules_file))
        if i % allowed == 1:
            tail = bytes(rng.choice(np.frombuffer(b"abcdefghij0123456789", np.uint8), 20))
            lines.insert(1, b'token = "itk_0000' + tail + b'"\\n')
        out.append((f"svc/app{i}.env", b"".join(lines)))
    return out
"""

CUSTOM_RUN = """\
import json, sys, time
sys.path[:0] = [{copy!r}, {repo!r}]
from portbench import compare, harness
from portbench.corpus import make_tree
rc = harness.run("custom.tiny", 2147483659, 0.5, False, t0=time.perf_counter(), device="cpu",
                 reference_workers=2)
cell = harness.load_cell("custom.tiny")
tree = make_tree(cell.traffic, 2147483659)
found = compare.reference_module(cell.config).answers(cell.config, tree)
print(json.dumps({{"rc": rc, "rules": sorted({{f[0] for a in found if a for f in a[1]}}),
                  "allowed": sum(b"itk_0000" in c for _, c in tree)}}))
"""


def _copy_with_custom_config(tmp_path, break_it: str = "") -> Path:
    """A copy of this folder with the custom configuration and its cell added
    as new files and manifest entries; returns the copy's root."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("_cache", "_out", "__pycache__"))
    (bench / "configs" / "secret-custom.yaml").write_text(CUSTOM_YAML)
    (bench / "reference" / "secret-custom-planted.json").write_text(json.dumps(CUSTOM_PLANTED))
    (bench / "configs" / "secret-custom.json").write_text(json.dumps(
        {"name": "secret-custom", "entry": "secret-custom",
         "reference": "custom_scan",
         "secret_config": "configs/secret-custom.yaml", "engine": {"backend": "hybrid"},
         "reduced": []}))
    (bench / "entries" / "secret-custom.py").write_text(CUSTOM_ENTRY.format(break_it=break_it))
    (bench / "reference" / "custom_scan.py").write_text(CUSTOM_REFERENCE)
    (bench / "shapes").mkdir(exist_ok=True)
    (bench / "shapes" / "custom.py").write_text(CUSTOM_SHAPE)
    (bench / "traffic" / "custom-tiny.json").write_text(json.dumps(
        {"shape": "custom", "n_files": 120, "planted_every": 4, "allowed_every": 5,
         "planted_rules": "secret-custom-planted",
         "batch_max_bytes": 268435456, "big_file_bytes": 33554432,
         "pass_offset_stride": 0.6180339887498949}))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "secret-custom", "source": "a test",
                                "file": "portbench/configs/secret-custom.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "custom.tiny", "config": "secret-custom",
                                  "traffic": "custom-tiny", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


def _run_custom(root: Path) -> tuple[dict, dict]:
    """The harness of the copy at `root` over the custom cell on the CPU:
    its result line, and what the reference finds in the tree."""
    done = subprocess.run([sys.executable, "-c", CUSTOM_RUN.format(copy=str(root),
                                                                   repo=str(ROOT))],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    lines = [json.loads(line) for line in done.stdout.splitlines() if line.startswith("{")]
    assert lines[-1]["rc"] == 0, done.stderr[-4000:]
    return lines[-2], lines[-1]


def test_a_new_config_traffic_and_metric_are_new_files_only(tmp_path):
    """A later change adds a cell as files and one manifest entry; the
    harness's own files stay as they are.  A configuration with its own
    rules, entry, reference and shape runs correct through them."""
    root = _copy_with_custom_config(tmp_path / "custom")
    result, found = _run_custom(root)
    assert result["correct"] and result["failed"] == 0, result
    assert result["compared"]["mismatched_files"] == {"value": 0, "limit": 0}
    assert result["attempted"] >= 120
    assert "internal-token" in found["rules"] and "github-pat" not in found["rules"]
    assert found["allowed"] > 0
    for name in ("harness.py", "run.py", "corpus.py", "compare.py", "devtrace.py", "loader.py",
                 "entries/secret.py", "reference/secret_scan.py"):
        assert (root / "portbench" / name).read_bytes() == (BENCH / name).read_bytes()

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


def test_a_new_config_whose_entry_drops_its_custom_rule_is_not_correct(tmp_path):
    """The same cell with an entry that builds the engine without the
    configuration's custom rule: the reference finds what it misses."""
    root = _copy_with_custom_config(tmp_path, break_it="secret_config.custom_rules = []")
    result, found = _run_custom(root)
    assert "internal-token" in found["rules"]
    assert not result["correct"] and result["failed"] > 0, result
    number = result["compared"]["mismatched_files"]
    assert number["value"] > number["limit"]


def test_the_config_shape_makes_the_trees_it_made():
    """The `config` shape, planting from the builtin rules by default, makes
    byte for byte the tree it made before shapes and planted rules were
    found by name (the digest of the earlier generator's output for this
    slice)."""
    t = json.loads((BENCH / "traffic" / "config-tree.json").read_text())
    assert t["shape"] == "config" and "planted_rules" not in t
    assert (compare.slice_digest(make_tree(t, 2_147_483_659, stop=200))
            == "942c32fc397dc3337f0d302a630395fd")


KERNEL_SHAPE = {"shape": "kernel", "n_files": 80000, "size_median": 3000, "size_sigma": 1.0,
                "size_min": 64, "size_max": 262144, "sizes_seed": 7, "pool_seed": 7,
                "pool_bytes": 8388608, "planted_every": 900, "planted_offset": 1}


def test_a_pool_seed_gives_every_seed_the_same_text_to_slice():
    """Every file of the kernel shape, whatever the run's seed, is a slice of
    the one pool that the traffic's `pool_seed` makes (the planted files
    aside), so the text's keyword hits, and the verify's work, do not follow
    the run's seed; a kernel traffic without a `pool_seed` is refused."""
    import numpy as np

    t = dict(KERNEL_SHAPE)
    pool = corpus._build_pool(np.random.default_rng(t["pool_seed"]), "c", t["pool_bytes"])
    header = b"// SPDX-License-Identifier: GPL-2.0\n"
    for seed in (3, 3_200_000_016):
        for i, (_, body) in enumerate(make_tree(t, seed, stop=120)):
            if i % t["planted_every"] != t["planted_offset"]:
                assert body.startswith(header) and body[len(header):] in pool, (seed, i)
    del t["pool_seed"]
    with pytest.raises(KeyError):
        make_tree(t, 3, stop=1)


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
