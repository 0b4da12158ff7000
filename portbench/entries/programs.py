"""Entry `programs`: the port's multi-program engine as
`make_program_engine` builds it, its default table (the secret program,
then the license program) over one sieve pass.

- `build`: `make_program_engine(**config["engine"])` through the rules
  cache, warmed up;
- `scan`: `scan_programs(files)`, one `(Secret, [LicenseFinding], corpus
  digest)` a file, the digest of the license classifier on the engine's
  device, which decided the findings;
- `keep`: the answers with a secret finding or a license finding;
- `answer`: `_license_form.answer` of the secret entry's canonical secret,
  the license findings and the digest.
"""

from portbench.entries import secret
from portbench.reference import _license_form
from trivy_tpu_torch.license.classifier import shared_classifier
from trivy_tpu_torch.programs import make_program_engine


def build(config: dict, device: str, rules_cache_dir):
    engine = make_program_engine(device=device, rules_cache_dir=str(rules_cache_dir),
                                 **config["engine"])
    engine.warmup()
    return engine


def scan(engine, files):
    out = engine.scan_programs(files)
    digest = shared_classifier(engine.device).corpus_digest
    return [(found, licenses, digest) for found, licenses in zip(out["secret"], out["license"])]


def keep(idxs, answers) -> tuple:
    return idxs, len(answers), {j: a for j, a in enumerate(answers) if a[0].findings or a[1]}


def answer(one) -> tuple:
    found, licenses, digest = one
    return _license_form.answer(
        secret.answer(found),
        [(f.name, f.category, f.severity, f.confidence, f.link) for f in licenses], digest)
