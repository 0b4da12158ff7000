"""Extension modules: custom analyzers and post-scan hooks (pkg/module).

The reference loads user WASM modules (wazero) exporting name/version/
required/analyze/post_scan and wires them into the analyzer registry and
the post-scan hook chain (module.go:446,482).  No WASM runtime ships in
this environment, so the module seam here loads *Python* files with the
same logical ABI — a deliberate, documented divergence: the extension
points and data shapes match, the sandboxing does not (a Python module
runs with the scanner's privileges; treat module dirs like executable
config).

Module ABI (module.go:43-88 exports, Pythonified):

    NAME: str                   # __name export
    VERSION: int                # __version
    def required(file_path: str, size: int) -> bool
    def analyze(file_path: str, content: bytes) -> dict | None
        # {"custom": any} attaches a custom resource to the scan
    def post_scan(results: list[dict]) -> list[dict] | None
        # results as JSON dicts; return the modified list (insert/update/
        # delete semantics, module.go:482-530)

Modules load from --module-dir (default ~/.trivy-tpu/modules).

Copied from `trivy_tpu/module.py`; the port imports nothing from the JAX
package.  A module analyzer is a per-file analyzer (`_ModuleAnalyzer`,
type `module:<name>`): it keeps the reference's tolerance (a raising
`required` claims nothing, a raising `analyze` logs and yields nothing),
and it can neither replace nor wrap the batch secret analyzer, whose
engine runs the card's kernels and whose failure still fails the scan.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from dataclasses import dataclass

logger = logging.getLogger(__name__)

DEFAULT_MODULE_DIR = os.path.join(
    os.path.expanduser("~"), ".trivy-tpu", "modules"
)


@dataclass
class LoadedModule:
    name: str
    version: int
    pymod: object

    def has(self, fn: str) -> bool:
        return callable(getattr(self.pymod, fn, None))


class ModuleManager:
    """module.Manager: load, register, and drive extension modules."""

    def __init__(self, module_dir: str = ""):
        self.module_dir = module_dir or DEFAULT_MODULE_DIR
        self.modules: list[LoadedModule] = []
        self._hook = None

    def load(self) -> list[LoadedModule]:
        if not os.path.isdir(self.module_dir):
            return []
        for fname in sorted(os.listdir(self.module_dir)):
            if not fname.endswith(".py") or fname.startswith("_"):
                continue
            path = os.path.join(self.module_dir, fname)
            try:
                spec = importlib.util.spec_from_file_location(
                    f"trivy_tpu_torch_module_{fname[:-3]}", path
                )
                pymod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(pymod)  # type: ignore[union-attr]
                name = getattr(pymod, "NAME", fname[:-3])
                version = int(getattr(pymod, "VERSION", 1))
            except Exception:
                logger.warning("module %s failed to load", path, exc_info=True)
                continue
            self.modules.append(LoadedModule(name, version, pymod))
            logger.info("loaded module %s v%d", name, version)
        return self.modules

    # -- analyzer seat ------------------------------------------------------

    def analyzers(self) -> list:
        """Per-scan analyzer adapters (wired through
        AnalyzerOptions.extra_analyzers, not the global registry, so modules
        stay scoped to the scan that loaded them)."""
        return [
            _ModuleAnalyzer(m)
            for m in self.modules
            if m.has("analyze") and m.has("required")
        ]

    def register(self) -> None:
        """Wire post_scan exports into the post-scan hook chain
        (module.go:482)."""
        from trivy_tpu_torch.scanner.post import register_post_scan_hook

        if any(m.has("post_scan") for m in self.modules):
            self._hook = self._post_scan
            register_post_scan_hook(self._hook)

    def unregister(self) -> None:
        if self._hook is not None:
            from trivy_tpu_torch.scanner.post import unregister_post_scan_hook

            unregister_post_scan_hook(self._hook)
            self._hook = None

    def _post_scan(self, results: list, custom_resources: list | None = None) -> list:
        import inspect

        for m in self.modules:
            if not m.has("post_scan"):
                continue
            try:
                json_results = [r.to_json() for r in results]
                fn = m.pymod.post_scan  # type: ignore[attr-defined]
                if len(inspect.signature(fn).parameters) >= 2:
                    out = fn(json_results, custom_resources or [])
                else:
                    out = fn(json_results)
                if out is None:
                    continue
                from trivy_tpu_torch.rpc.convert import result_from_json

                results = [result_from_json(r) for r in out]
            except Exception:
                logger.warning(
                    "module %s post_scan failed", m.name, exc_info=True
                )
        return results


class _ModuleAnalyzer:
    """Adapter: module analyze export -> analyzer registry seat."""

    def __init__(self, module: LoadedModule):
        self._m = module

    def init(self, options) -> None:
        pass

    def type(self) -> str:
        return f"module:{self._m.name}"

    def version(self) -> int:
        return self._m.version

    def required(self, file_path: str, size: int, mode: int) -> bool:
        try:
            return bool(self._m.pymod.required(file_path, size))  # type: ignore[attr-defined]
        except Exception:
            return False

    def analyze(self, inp):
        from trivy_tpu_torch.analyzer.core import AnalysisResult

        try:
            out = self._m.pymod.analyze(inp.file_path, inp.content)  # type: ignore[attr-defined]
        except Exception:
            logger.warning(
                "module %s analyze failed on %s",
                self._m.name,
                inp.file_path,
                exc_info=True,
            )
            return None
        if not out:
            return None
        result = AnalysisResult()
        result.configs.append(out)
        return result
