"""Entry `secret`: the port's secret engine as `make_secret_engine` builds it.

An entry (`portbench/entries/<name>.py`, named by a configuration's `entry`
key) is how the harness drives the program:

- `build(config, device, rules_cache_dir)`: the engine, warmed up;
- `scan(engine, files)`: one answer per `(path, content)` of `files`;
- `keep(idxs, answers)`: what the comparison needs of one batch;
- `answer(one)`: one kept answer in its reference's canonical form.

This one builds `make_secret_engine(**config["engine"])`, scans with
`scan_batch`, and reads its `Secret` results.
"""

from portbench.reference.secret_scan import canonical
from trivy_tpu_torch.engine.hybrid import make_secret_engine


def build(config: dict, device: str, rules_cache_dir):
    engine = make_secret_engine(device=device, rules_cache_dir=str(rules_cache_dir),
                                **config["engine"])
    engine.warmup()
    return engine


def scan(engine, files):
    return engine.scan_batch(files)


def keep(idxs, answers) -> tuple:
    """The file indices, the number of answers and those that carry findings
    (an answer without findings compares as `()`, whatever object it is), so
    the window does not hold every empty result for the collector to walk."""
    return idxs, len(answers), {j: r for j, r in enumerate(answers) if r.findings}


def answer(secret) -> tuple:
    """A `Secret` result of the program in the reference's canonical form;
    `("unordered", path)` when its findings break Go's order (RuleID, then
    the raw match line), `("garbled", path)` when a finding's match text is
    not its raw match line decoded."""
    findings = secret.findings
    if not findings:
        return ()
    keys = [(f.rule_id, f.match_bytes) for f in findings]
    if keys != sorted(keys):
        return ("unordered", secret.file_path)
    rows = []
    for f in findings:
        if f.match != f.match_bytes.decode("utf-8", errors="replace"):
            return ("garbled", secret.file_path)
        code = tuple((ln.number, ln.content, ln.highlighted, ln.is_cause, ln.first_cause,
                      ln.last_cause) for ln in f.code.lines)
        rows.append((f.rule_id, f.category, f.severity, f.title, f.start_line,
                     f.end_line, f.match_bytes, code))
    return canonical(secret.file_path, rows)
