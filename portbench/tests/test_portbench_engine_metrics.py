"""The metrics that read the default engine's own counters
(`SieveStats.sieve_wait_s`, `verify_dispatch_s`, the engine's
`build_times`): a traced run of the cell on the CPU reports them as
numbers, and a program without those counters gives nothing to read."""

import json
import time
from types import SimpleNamespace

from portbench import harness

NEW = ("sieve_wait_s_per_scan", "verify_dispatch_s_per_scan", "engine_link_probe_s",
       "engine_tables_s")


def test_a_traced_cpu_run_reports_the_engine_counters(capsys):
    rc = harness.run("default.config-tree", 2_147_483_659, 1.0, True, t0=time.perf_counter(),
                     device="cpu", traffic_overrides={"n_files": 300}, reference_workers=2)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"]
    for name in NEW:
        assert isinstance(result["metrics"][name]["value"], float), name
        assert result["metrics"][name]["value"] >= 0 and result["metrics"][name]["unit"] == "s"


def test_a_program_without_the_counters_reads_nothing():
    config = {"engine": {"backend": "auto"}}
    run = SimpleNamespace(config=config, scans=2.0, state={},
                          stats={"sieve_s": 0.5, "verify_s": 0.8})
    for name in NEW:
        mod = harness.reader(name)
        if hasattr(mod, "on_batch"):
            mod.on_batch(run, SimpleNamespace(stats=None))
        assert mod.read(run) is None, name
