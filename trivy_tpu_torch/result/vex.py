"""VEX (Vulnerability Exploitability eXchange) ingestion.

Mirrors pkg/vex/vex.go: OpenVEX, CycloneDX-VEX, and CSAF documents
suppress detected vulnerabilities whose status is not_affected/fixed for
the scanned product (csaf.go:26-83: CVE match -> product_status range ->
product-tree purl match).

Copied from `trivy_tpu/result/vex.py`; the port imports nothing from the
JAX package.  Products' purls come from the port's `purl.package_url`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from trivy_tpu_torch.purl import package_url

SUPPRESS_STATUSES = {"not_affected", "fixed"}


@dataclass
class VexDocument:
    # (vuln_id, product purl or "" for any) -> status
    statements: dict[tuple[str, str], str] = field(default_factory=dict)

    def _by_vuln(self) -> dict[str, list[tuple[str, str]]]:
        # vuln_id -> [(purl, status)]: built once so suppressed() stays
        # O(statements-for-this-vuln), not O(all statements) per call.
        if not hasattr(self, "_index"):
            index: dict[str, list[tuple[str, str]]] = {}
            for (vid, vpurl), status in self.statements.items():
                index.setdefault(vid, []).append((vpurl, status))
            self._index = index
        return self._index

    def suppressed(self, vuln_id: str, purl: str = "") -> bool:
        for vpurl, status in self._by_vuln().get(vuln_id, []):
            if status not in SUPPRESS_STATUSES:
                continue
            if vpurl == "" or vpurl == purl:
                return True
            # Versionless VEX purls cover all versions of the package
            # (purl.Match semantics; CSAF trees commonly omit @version).
            if purl and _purl_matches(vpurl, purl):
                return True
        return False


def load_vex(path: str) -> VexDocument:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if "statements" in data:  # OpenVEX
        return _parse_openvex(data)
    if data.get("bomFormat") == "CycloneDX":  # CycloneDX VEX
        return _parse_cyclonedx_vex(data)
    if "document" in data and "vulnerabilities" in data:  # CSAF
        return _parse_csaf(data)
    raise ValueError(f"unrecognized VEX document: {path}")


def _parse_openvex(data: dict) -> VexDocument:
    doc = VexDocument()
    for st in data.get("statements") or []:
        vuln = st.get("vulnerability", "")
        if isinstance(vuln, dict):  # v0.2.0 object form; older docs use a str
            vuln = vuln.get("name", "")
        status = st.get("status", "")
        products = st.get("products") or []
        if not products:
            doc.statements[(vuln, "")] = status
        for p in products:
            pid = p.get("@id", "") if isinstance(p, dict) else str(p)
            doc.statements[(vuln, pid)] = status
    return doc


def _parse_cyclonedx_vex(data: dict) -> VexDocument:
    doc = VexDocument()
    for v in data.get("vulnerabilities") or []:
        vuln_id = v.get("id", "")
        analysis = (v.get("analysis") or {}).get("state", "")
        # CycloneDX states map: not_affected / resolved -> suppress
        status = {
            "not_affected": "not_affected",
            "resolved": "fixed",
            "resolved_with_pedigree": "fixed",
        }.get(analysis, analysis)
        for affect in v.get("affects") or []:
            doc.statements[(vuln_id, affect.get("ref", ""))] = status
        if not v.get("affects"):
            doc.statements[(vuln_id, "")] = status
    return doc


def _csaf_product_purls(tree: dict) -> dict[str, list[str]]:
    """product id -> purls, from the product tree's branches and
    relationships (csaf.go CollectProductIdentificationHelpers)."""
    purls: dict[str, list[str]] = {}

    def walk(branch: dict) -> None:
        product = branch.get("product") or {}
        pid = product.get("product_id", "")
        helper = product.get("product_identification_helper") or {}
        if pid and helper.get("purl"):
            purls.setdefault(pid, []).append(helper["purl"])
        for sub in branch.get("branches") or []:
            walk(sub)

    for b in (tree.get("branches") or []):
        walk(b)
    # Relationship products (e.g. "pkg as a component of product") inherit
    # the purls of the products they reference (csaf.go:96-118).  Chains
    # (pkg -> module -> stream) and forward references need iteration to a
    # fixpoint, not one document-order pass.
    rels = [
        (
            (rel.get("full_product_name") or {}).get("product_id", ""),
            rel.get("product_reference", ""),
        )
        for rel in tree.get("relationships") or []
    ]
    changed = True
    while changed:
        changed = False
        for full, ref in rels:
            if not full or ref not in purls:
                continue
            have = purls.setdefault(full, [])
            new = [p for p in purls[ref] if p not in have]
            if new:
                have.extend(new)
                changed = True
    return purls


def _purl_matches(vex_purl: str, pkg_purl: str) -> bool:
    """Version-insensitive prefix match: a versionless CSAF purl covers
    every version of the package (purl.Match semantics)."""
    if vex_purl == pkg_purl:
        return True
    base = vex_purl.split("?")[0]
    if "@" not in base.rsplit("/", 1)[-1]:
        return pkg_purl.split("?")[0].split("@")[0] == base
    return False


def _parse_csaf(data: dict) -> VexDocument:
    doc = VexDocument()
    product_purls = _csaf_product_purls(data.get("product_tree") or {})
    for vuln in data.get("vulnerabilities") or []:
        cve = vuln.get("cve", "")
        if not cve:
            continue
        status_map = vuln.get("product_status") or {}
        for status_key, status in (
            ("known_not_affected", "not_affected"),
            ("fixed", "fixed"),
        ):
            for pid in status_map.get(status_key) or []:
                for p in product_purls.get(pid, []):
                    doc.statements[(cve, p)] = status
    return doc


def apply_vex(report, vex: VexDocument) -> None:
    """Filter hook (pkg/result/filter.go VEX step)."""
    for result in report.results:
        kept = []
        for v in result.vulnerabilities:
            vid = getattr(v, "vulnerability_id", "")
            purl = ""
            try:
                purl = package_url(
                    result.result_type,
                    getattr(v, "pkg_name", ""),
                    getattr(v, "installed_version", ""),
                )
            except Exception:
                pass
            if not vex.suppressed(vid, purl):
                kept.append(v)
        result.vulnerabilities = kept

