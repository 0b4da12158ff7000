"""Structured rego input documents per IaC file type.

Shapes mirror the reference so checks written for trivy port over:
  dockerfile -> pkg/iac/providers/dockerfile/dockerfile.go ToRego():
      {"Stages": [{"Name": ..., "Commands": [{"Cmd", "SubCmd", "Flags",
       "Value", "Original", "JSON", "Stage", "Path", "StartLine",
       "EndLine"}]}]}
  kubernetes -> the YAML document itself (trivy feeds parsed YAML straight
      to rego for k8s checks), with __startline__/__endline__ markers on
      mappings (pkg/iac/scanners/kubernetes parser convention)
  terraform  -> conftest-style document (iac/hcl.py terraform_input)

Copied from `trivy_tpu/iac/inputs.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import json
import re
import shlex
from typing import Any

from trivy_tpu_torch.iac.hcl import terraform_input

__all__ = [
    "dockerfile_input",
    "kubernetes_inputs",
    "terraform_input",
    "detect_type",
]


def detect_type(file_path: str, content: bytes) -> str | None:
    """File-type routing (pkg/misconf/scanner.go:82-112 per-type scanners +
    pkg/iac/detection: content sniffing decides between k8s manifests,
    CloudFormation templates, ARM templates, and plan files sharing the
    same extensions)."""
    name = file_path.rsplit("/", 1)[-1].lower()
    if name == "dockerfile" or name.startswith("dockerfile.") or name.endswith(
        ".dockerfile"
    ):
        return "dockerfile"
    if name.endswith((".tf", ".tf.json")):
        return "terraform"
    if name.endswith((".yaml", ".yml")):
        # Unrendered helm templates also reach here; they fail the YAML
        # parse downstream and produce nothing, while the helm
        # post-analyzer rescans their rendered form (the applier dedupes
        # by file path if a template happens to be valid YAML as-is).
        if b"apiVersion" in content and b"kind" in content:
            return "kubernetes"
        if b"Resources" in content and (
            b"AWSTemplateFormatVersion" in content
            or b"AWS::" in content
        ):
            return "cloudformation"
        return "yaml"  # generic: only custom yaml-namespace checks fire
    if name.endswith(".toml"):
        return "toml"
    if name.endswith((".json", ".template")):
        try:
            doc = json.loads(content)
        except ValueError:
            # .template is also a common extension for YAML-format
            # CloudFormation; apply the same content sniff as .yaml.
            if name.endswith(".template") and b"Resources" in content and (
                b"AWSTemplateFormatVersion" in content or b"AWS::" in content
            ):
                return "cloudformation"
            return None
        if isinstance(doc, list):
            return "json"  # generic: custom json-namespace checks
        if not isinstance(doc, dict):
            return None
        if "apiVersion" in doc and "kind" in doc:
            return "kubernetes"
        if isinstance(doc.get("Resources"), dict) and (
            "AWSTemplateFormatVersion" in doc
            or any(
                isinstance(r, dict) and str(r.get("Type", "")).startswith("AWS::")
                for r in doc["Resources"].values()
            )
        ):
            return "cloudformation"
        if "deploymentTemplate.json" in str(doc.get("$schema", "")):
            return "azure-arm"
        if "planned_values" in doc and "terraform_version" in doc:
            return "tfplan"
        return "json"  # generic
    return None


# ---------------------------------------------------------------------------
# dockerfile
# ---------------------------------------------------------------------------

_FLAG_RE = re.compile(r"^--[A-Za-z][\w-]*(=\S*)?$")


def dockerfile_input(content: bytes) -> dict[str, Any]:
    from trivy_tpu_torch.misconf.dockerfile import parse_dockerfile

    instructions = parse_dockerfile(content)
    stages: list[dict[str, Any]] = []
    cur: dict[str, Any] | None = None
    stage_idx = -1
    for ins in instructions:
        cmd = ins.cmd.lower()
        value = ins.value
        flags: list[str] = []
        sub = ""
        rest = value
        if cmd in ("run", "copy", "add", "from", "healthcheck"):
            parts = rest.split()
            while parts and _FLAG_RE.match(parts[0]):
                flags.append(parts[0])
                parts.pop(0)
            rest = " ".join(parts)
        if cmd == "healthcheck" and rest.split()[:1]:
            sub = rest.split()[0].upper()
        is_json = rest.lstrip().startswith("[")
        if is_json:
            try:
                vals = [str(v) for v in json.loads(rest)]
            except ValueError:
                vals = [rest]
                is_json = False
        elif cmd in ("run",):
            vals = [rest]
        else:
            try:
                vals = shlex.split(rest)
            except ValueError:
                vals = rest.split()
        command = {
            "Cmd": cmd,
            "SubCmd": sub.lower(),
            "Flags": flags,
            "Value": vals,
            "Original": f"{ins.cmd} {ins.value}".strip(),
            "JSON": is_json,
            "Stage": stage_idx if cmd != "from" else stage_idx + 1,
            "Path": "",
            "StartLine": ins.start_line,
            "EndLine": ins.end_line,
        }
        if cmd == "from":
            stage_idx += 1
            cur = {"Name": ins.value, "Commands": [command]}
            stages.append(cur)
        else:
            if cur is None:  # instructions before any FROM (ARG is legal)
                stage_idx = 0
                cur = {"Name": "", "Commands": []}
                stages.append(cur)
                command["Stage"] = 0
            cur["Commands"].append(command)
    return {"Stages": stages}


# ---------------------------------------------------------------------------
# kubernetes
# ---------------------------------------------------------------------------


class _LineLoaderFactory:
    _cls = None

    @classmethod
    def get(cls):
        if cls._cls is not None:
            return cls._cls
        import yaml

        class LineLoader(yaml.SafeLoader):
            pass

        def construct_mapping(loader, node, deep=False):
            mapping = yaml.SafeLoader.construct_mapping(loader, node, deep=deep)
            mapping["__startline__"] = node.start_mark.line + 1
            mapping["__endline__"] = node.end_mark.line + 1
            return mapping

        LineLoader.add_constructor(
            yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, construct_mapping
        )
        cls._cls = LineLoader
        return cls._cls


def kubernetes_inputs(content: bytes) -> list[dict[str, Any]]:
    """Parse (possibly multi-document) k8s YAML or JSON with line markers."""
    text = content.decode("utf-8", errors="replace")
    if text.lstrip().startswith("{"):
        try:
            doc = json.loads(text)
        except ValueError:
            return []
        return [doc] if isinstance(doc, dict) else []
    import yaml

    out = []
    try:
        for doc in yaml.load_all(text, Loader=_LineLoaderFactory.get()):
            if isinstance(doc, dict) and doc.get("kind"):
                out.append(doc)
    except yaml.YAMLError:
        return []
    return out


# ---------------------------------------------------------------------------
# cloudformation
# ---------------------------------------------------------------------------


_CFN_LOADER_CLS = None


def _cfn_loader():
    """YAML loader understanding CloudFormation's short intrinsic tags
    (!Ref, !Sub, !GetAtt, ...), normalized to the long Fn:: forms the
    JSON template syntax uses (pkg/iac/scanners/cloudformation parser).
    The class is built once (same pattern as _LineLoaderFactory)."""
    global _CFN_LOADER_CLS
    if _CFN_LOADER_CLS is not None:
        return _CFN_LOADER_CLS
    import yaml

    class CfnLoader(yaml.SafeLoader):
        pass

    def tag(loader, tag_suffix, node):
        if isinstance(node, yaml.ScalarNode):
            value: Any = loader.construct_scalar(node)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            value = loader.construct_mapping(node, deep=True)
        if tag_suffix == "Ref":
            return {"Ref": value}
        if tag_suffix == "Condition":
            return {"Condition": value}
        if tag_suffix == "GetAtt" and isinstance(value, str):
            value = value.split(".", 1)
        return {f"Fn::{tag_suffix}": value}

    CfnLoader.add_multi_constructor("!", tag)
    _CFN_LOADER_CLS = CfnLoader
    return CfnLoader


def _cfn_resolve(value: Any, params: dict[str, Any]) -> Any:
    """Resolve Ref/Fn::Sub against parameter defaults so checks see values
    (cloudformation/parser resolution, defaults only — no stack inputs)."""
    if isinstance(value, dict):
        if len(value) == 1:
            (k, v), = value.items()
            if k == "Ref" and isinstance(v, str) and v in params:
                return params[v]
            if k == "Fn::Sub" and isinstance(v, str):
                def sub(m):
                    name = m.group(1)
                    return str(params.get(name, m.group(0)))
                return re.sub(r"\$\{([A-Za-z0-9:.]+)\}", sub, v)
        return {k: _cfn_resolve(v, params) for k, v in value.items()}
    if isinstance(value, list):
        return [_cfn_resolve(v, params) for v in value]
    return value


def cloudformation_input(content: bytes) -> dict[str, Any] | None:
    """CloudFormation template (YAML or JSON) -> rego input document:
    the template itself with parameter defaults folded into Ref/Sub."""
    import yaml

    text = content.decode("utf-8", errors="replace")
    try:
        if text.lstrip().startswith("{"):
            doc = json.loads(text)
        else:
            doc = yaml.load(text, Loader=_cfn_loader())
    except (ValueError, yaml.YAMLError):
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("Resources"), dict):
        return None
    params = {
        name: blk.get("Default")
        for name, blk in (doc.get("Parameters") or {}).items()
        if isinstance(blk, dict) and "Default" in blk
    }
    return _cfn_resolve(doc, params)


# ---------------------------------------------------------------------------
# terraform plan / azure ARM
# ---------------------------------------------------------------------------


def tfplan_input(content: bytes) -> dict[str, Any] | None:
    """terraform plan JSON -> the conftest-style terraform document shape,
    so the terraform check corpus applies to plans (the reference's
    terraformplan scanner converts plans back into HCL-shaped state)."""
    try:
        doc = json.loads(content)
    except ValueError:
        return None
    if not isinstance(doc, dict):
        return None
    resources: dict[str, dict[str, Any]] = {}

    def walk(module: dict[str, Any]) -> None:
        for res in module.get("resources") or []:
            if res.get("mode") == "data":
                continue  # data sources are reads, not planned resources
            rtype, name = res.get("type"), res.get("name")
            values = res.get("values")
            if not rtype or not name or not isinstance(values, dict):
                continue
            # Key by the unique address: the same type+name recurs across
            # module instances and must not overwrite.
            key = res.get("address") or name
            resources.setdefault(rtype, {})[key] = values
        for child in module.get("child_modules") or []:
            walk(child)

    walk((doc.get("planned_values") or {}).get("root_module") or {})
    return {"resource": resources} if resources else None


def azure_arm_input(content: bytes) -> dict[str, Any] | None:
    """Azure ARM deployment template -> rego input with parameter
    defaultValue folded into [parameters('name')] expressions."""
    try:
        doc = json.loads(content)
    except ValueError:
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("resources"), list):
        return None
    params = {
        name: blk.get("defaultValue")
        for name, blk in (doc.get("parameters") or {}).items()
        if isinstance(blk, dict) and "defaultValue" in blk
    }

    def resolve(value: Any) -> Any:
        if isinstance(value, str):
            m = re.fullmatch(r"\[parameters\('([^']+)'\)\]", value.strip())
            if m and m.group(1) in params:
                return params[m.group(1)]
            return value
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v) for v in value]
        return value

    return resolve(doc)
