"""Secret analyzer: pre-filter + adapter onto the device secret engine.

Mirrors pkg/fanal/analyzer/secret/secret.go — skip lists (:28-42), Required
gate (:115-153), binary sniff (utils.IsBinary, pkg/fanal/utils/utils.go:76-93),
``\r`` stripping (:91), leading ``/`` for image-extracted files (:97-99) — but
implements BatchAnalyzer so all claimed files of a walk board the device as one
packed batch.

Copied from `trivy_tpu/analyzer/secret.py`; the port imports nothing from
the JAX package.  The engine is the port's `make_secret_engine` on the
scanner option's `device` (default "cuda"), or `RemoteSecretEngine` for
`--secret-backend server` (fleet routing waits for ROADMAP A13c).  The
claim pass keeps the reference's per-file gate loop for every corpus: its
joined-needle fast path and the batched allow-path regex give the same
verdicts and are left out.
"""

from __future__ import annotations

import os

from trivy_tpu_torch.analyzer.core import (
    TYPE_SECRET,
    AnalysisInput,
    AnalysisResult,
    AnalyzerOptions,
    BatchAnalyzer,
    SecretScannerOption,
    register_analyzer,
)
from trivy_tpu_torch.rules.model import load_config

VERSION = 1

# secret.go:28-42
SKIP_FILES = {
    "go.mod",
    "go.sum",
    "package-lock.json",
    "yarn.lock",
    "pnpm-lock.yaml",
    "Pipfile.lock",
    "Gemfile.lock",
}
SKIP_DIRS = {".git", "node_modules"}
# Component-exact substring needles for the claim pass: dir components are
# always followed by "/" in a full path, the basename never is (derived so
# SKIP_DIRS edits propagate).
_SKIP_DIR_NEEDLES = tuple(f"/{d}/" for d in SKIP_DIRS)
SKIP_EXTS = {
    ".jpg", ".png", ".gif", ".doc", ".pdf", ".bin", ".svg", ".socket",
    ".deb", ".rpm", ".zip", ".gz", ".gzip", ".tar", ".pyc",
}


# Bytes the reference's control-byte heuristic accepts as text; translate()
# deletes them at C speed, so anything left over marks the file binary.
_TEXT_BYTES = bytes(
    b
    for b in range(256)
    if not (
        b < 7 or b == 11 or (13 < b < 27) or (27 < b < 0x20) or b == 0x7F
    )
)


def is_binary(head: bytes) -> bool:
    """utils.IsBinary control-byte heuristic over the first 300 bytes
    (pkg/fanal/utils/utils.go:76-93)."""
    return bool(head[:300].translate(None, _TEXT_BYTES))


class SecretAnalyzer(BatchAnalyzer):
    """pkg/fanal/analyzer/secret/secret.go SecretAnalyzer."""

    def __init__(self) -> None:
        self._engine = None
        self._option = SecretScannerOption()
        self._config_skip_paths: frozenset[str] = frozenset()

    def init(self, options: AnalyzerOptions) -> None:
        self._option = options.secret_scanner_option
        self._config_skip_paths = self._build_config_skip_paths(
            self._option.config_path
        )

    @staticmethod
    def _build_config_skip_paths(config_path: str) -> frozenset[str]:
        """Forms of the secret-config path to exclude from scanning.

        The reference skips the scanned file whose path equals
        filepath.Base(configPath) (secret.go:138).  Basename alone misses
        the common case where the config lives in a subdirectory of the
        scan tree and the walker reports it by relative path — a config
        given as ``configs/trivy-secret.yaml`` arrives at required() as
        exactly that string, never as the bare basename, so the file's own
        example rules would be scanned and reported as findings.  Skip the
        normalized relative path too; path normalization keeps the match
        exact (no suffix matching), so ``other/configs/trivy-secret.yaml``
        is still scanned.
        """
        if not config_path:
            return frozenset()
        norm = os.path.normpath(config_path).replace(os.sep, "/")
        if norm.startswith("./"):
            norm = norm[2:]
        return frozenset({os.path.basename(config_path), norm})

    @property
    def engine(self):
        """Built on first use (the claim pass asks it for the allow paths),
        under the host span `secret.engine`: a remote engine for the server
        backend, else the port's local engine for the backend on the
        option's device."""
        if self._engine is None:
            from trivy_tpu_torch.obs import trace as obs_trace

            with obs_trace.span("secret.engine"):
                self._engine = self._build_engine()
        return self._engine

    def _build_engine(self):
        opt = self._option
        config = load_config(opt.config_path)
        if opt.backend == "server":
            # The sidecar split: raw (path, blob) items board the scan
            # server's continuous batcher instead of a local engine, so
            # concurrent client processes share one device batch.
            from trivy_tpu_torch.rpc.client import RemoteSecretEngine

            if not opt.server_addr:
                raise ValueError("--secret-backend server requires --server")
            return RemoteSecretEngine(
                opt.server_addr,
                token=opt.server_token,
                timeout_s=opt.timeout_s,
                ruleset_select=opt.ruleset_select,
                explain=opt.explain,
            )
        # All local backends go through the factory, which maps the CLI
        # aliases (cpu/tpu/native) and — when the registry is on —
        # warm-starts from a cached compiled artifact instead of recompiling
        # the ruleset in-process.
        from trivy_tpu_torch.engine.hybrid import make_secret_engine
        from trivy_tpu_torch.registry.store import resolve_rules_cache_dir

        kw = {}
        if opt.pipeline_depth is not None:
            kw["pipeline_depth"] = opt.pipeline_depth
        if opt.resident_chunks is not None:
            kw["resident_chunks"] = opt.resident_chunks
        return make_secret_engine(
            config=config,
            backend=opt.backend,
            device=opt.device,
            rules_cache_dir=resolve_rules_cache_dir(opt.rules_cache_dir),
            **kw,
        )

    def type(self) -> str:
        return TYPE_SECRET

    def version(self) -> int:
        return VERSION

    def required(self, file_path: str, size: int, mode: int) -> bool:
        """secret.go:115-153."""
        if size < 10:
            return False
        dirname, fname = os.path.split(file_path)
        if SKIP_DIRS.intersection(dirname.replace(os.sep, "/").split("/")):
            return False
        if fname in SKIP_FILES:
            return False
        if self._config_skip_paths and (
            file_path.replace(os.sep, "/") in self._config_skip_paths
        ):
            return False
        if os.path.splitext(fname)[1] in SKIP_EXTS:
            return False
        if self.engine_allow_path(file_path):
            return False
        return True

    def engine_allow_path(self, file_path: str) -> bool:
        eng = self.engine
        ruleset = getattr(eng, "ruleset", None)
        return bool(ruleset and ruleset.allow_path(file_path))

    def required_batch(self, files: list[tuple[str, int]]) -> list[bool]:
        """required() over a corpus in one pass, the checks in the
        reference's order (secret.go:115-153); the engine is asked for the
        allow paths once."""
        ruleset = getattr(self.engine, "ruleset", None)
        skip_ext_tuple = tuple(SKIP_EXTS)
        cfg_skips = self._config_skip_paths
        sep = os.sep
        out = []
        for path, size in files:
            if size < 10:
                out.append(False)
                continue
            p = path.replace(sep, "/") if sep != "/" else path
            slashed = "/" + p
            if any(nd in slashed for nd in _SKIP_DIR_NEEDLES):
                out.append(False)
                continue
            base = p.rsplit("/", 1)[-1]
            if base in SKIP_FILES:
                out.append(False)
                continue
            if cfg_skips and p in cfg_skips:
                out.append(False)
                continue
            if base.endswith(skip_ext_tuple) and (
                os.path.splitext(base)[1] in SKIP_EXTS
            ):
                out.append(False)
                continue
            out.append(not (ruleset and ruleset.allow_path(path)))
        return out

    @staticmethod
    def _effective_path(inp: AnalysisInput) -> str:
        # Files extracted from images have no dir; they get a leading "/"
        # (secret.go:94-99).
        return inp.file_path if inp.dir else "/" + inp.file_path

    def analyze_batch(self, inputs: list[AnalysisInput]) -> AnalysisResult | None:
        items: list[tuple[str, bytes]] = []
        for inp in inputs:
            if is_binary(inp.content):
                continue
            content = inp.content.replace(b"\r", b"")
            items.append((self._effective_path(inp), content))
        if not items:
            return None

        eng = self.engine
        if hasattr(eng, "scan_batch"):
            results = eng.scan_batch(items)
        else:
            results = [eng.scan(p, c) for p, c in items]

        secrets = [r for r in results if r.findings]
        if not secrets:
            return None
        return AnalysisResult(secrets=secrets)


register_analyzer(SecretAnalyzer)
