"""Version comparators per packaging ecosystem.

Mirrors the comparator libraries the reference pulls in (go-deb-version,
go-apk-version, go-npm-version, go-pep440-version — see pkg/detector/ospkg/*
and pkg/detector/library/compare/*).  Each returns <0, 0, >0.

Copied from `trivy_tpu/detector/version_cmp.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import re


# ---------------------------------------------------------------------------
# dpkg (Debian policy 5.6.12)
# ---------------------------------------------------------------------------


def _deb_order(c: str) -> int:
    if c == "~":
        return -1
    if c.isalpha():
        return ord(c)
    if not c:
        return 0
    return ord(c) + 256  # non-alphanumeric sorts after letters


def _deb_compare_part(a: str, b: str) -> int:
    ia = ib = 0
    while ia < len(a) or ib < len(b):
        # non-digit run
        while True:
            ca = a[ia] if ia < len(a) and not a[ia].isdigit() else ""
            cb = b[ib] if ib < len(b) and not b[ib].isdigit() else ""
            if not ca and not cb:
                break
            oa, ob = _deb_order(ca), _deb_order(cb)
            if oa != ob:
                return -1 if oa < ob else 1
            ia += bool(ca)
            ib += bool(cb)
        # digit run
        na = nb = 0
        while ia < len(a) and a[ia].isdigit():
            na = na * 10 + int(a[ia])
            ia += 1
        while ib < len(b) and b[ib].isdigit():
            nb = nb * 10 + int(b[ib])
            ib += 1
        if na != nb:
            return -1 if na < nb else 1
    return 0


def _deb_split(v: str) -> tuple[int, str, str]:
    epoch = 0
    if ":" in v:
        e, _, v = v.partition(":")
        if e.isdigit():
            epoch = int(e)
    upstream, _, revision = v.rpartition("-")
    if not upstream:
        upstream, revision = v, ""
    return epoch, upstream, revision


def compare_deb(a: str, b: str) -> int:
    ea, ua, ra = _deb_split(a)
    eb, ub, rb = _deb_split(b)
    if ea != eb:
        return -1 if ea < eb else 1
    c = _deb_compare_part(ua, ub)
    if c:
        return c
    return _deb_compare_part(ra, rb)


# ---------------------------------------------------------------------------
# apk (Alpine)
# ---------------------------------------------------------------------------

_APK_SUFFIXES = {"alpha": -4, "beta": -3, "pre": -2, "rc": -1, "": 0, "cvs": 1,
                 "svn": 2, "git": 3, "hg": 4, "p": 5}
_APK_TOKEN = re.compile(
    r"(\d+)|([a-z])|_(alpha|beta|pre|rc|cvs|svn|git|hg|p)(\d*)|(-r)(\d+)|(.)"
)


def _apk_tokens(v: str):
    out = []
    for m in _APK_TOKEN.finditer(v.lower()):
        if m.group(1) is not None:
            out.append(("num", int(m.group(1))))
        elif m.group(2) is not None:
            out.append(("alpha", m.group(2)))
        elif m.group(3) is not None:
            out.append(("suffix", _APK_SUFFIXES[m.group(3)],
                        int(m.group(4) or 0)))
        elif m.group(5) is not None:
            out.append(("rev", int(m.group(6))))
    return out


def compare_apk(a: str, b: str) -> int:
    ta, tb = _apk_tokens(a), _apk_tokens(b)
    for i in range(max(len(ta), len(tb))):
        xa = ta[i] if i < len(ta) else None
        xb = tb[i] if i < len(tb) else None
        if xa == xb:
            continue
        # missing token: a bare version < one with extra numbers, but a
        # negative suffix (_rc etc.) sorts below a bare version.
        if xa is None:
            return 1 if (xb[0] == "suffix" and xb[1] < 0) else -1
        if xb is None:
            return -1 if (xa[0] == "suffix" and xa[1] < 0) else 1
        if xa[0] != xb[0]:
            order = {"num": 0, "alpha": 1, "suffix": 2, "rev": 3}
            return -1 if order.get(xa[0], 9) < order.get(xb[0], 9) else 1
        return -1 if xa < xb else 1
    return 0


# ---------------------------------------------------------------------------
# semver (npm & friends)
# ---------------------------------------------------------------------------

_SEMVER = re.compile(
    r"^v?(\d+)(?:\.(\d+))?(?:\.(\d+))?(?:-([0-9A-Za-z.-]+))?(?:\+.*)?$"
)


def _semver_key(v: str):
    m = _SEMVER.match(v.strip())
    if not m:
        # Fallback: numeric runs + the raw tail as a pseudo-prerelease, shaped
        # like the regular pre_key so cross-form comparisons never TypeError.
        nums = [int(x) for x in re.findall(r"\d+", v)[:4]]
        return (tuple(nums + [0] * (3 - len(nums))), ((0,), (0.5, v)))
    major, minor, patch = (int(m.group(i) or 0) for i in (1, 2, 3))
    pre = m.group(4)
    if pre is None:
        pre_key = ((1,),)  # release > any prerelease
    else:
        parts = []
        for p in pre.split("."):
            parts.append((0, int(p)) if p.isdigit() else (0.5, p))
        pre_key = ((0,), *parts)
    return ((major, minor, patch), pre_key)


def compare_semver(a: str, b: str) -> int:
    ka, kb = _semver_key(a), _semver_key(b)
    return -1 if ka < kb else (1 if ka > kb else 0)


# ---------------------------------------------------------------------------
# pep440 (PyPI)
# ---------------------------------------------------------------------------


def compare_pep440(a: str, b: str) -> int:
    try:
        from packaging.version import Version

        va, vb = Version(a), Version(b)
        return -1 if va < vb else (1 if va > vb else 0)
    except Exception:
        return compare_semver(a, b)


# ---------------------------------------------------------------------------
# generic / rubygems (close enough to semver with letter segments)
# ---------------------------------------------------------------------------


def compare_generic(a: str, b: str) -> int:
    return _deb_compare_part(a, b)


def _rpm_seg_cmp(a: str, b: str) -> int:
    """librpm rpmvercmp over one version component: alternating digit and
    alpha runs; tilde sorts before everything, caret after release-equal."""
    ia = ib = 0
    while ia < len(a) or ib < len(b):
        ca = a[ia] if ia < len(a) else ""
        cb = b[ib] if ib < len(b) else ""
        if ca == "~" or cb == "~":
            if ca != "~":
                return 1
            if cb != "~":
                return -1
            ia += 1
            ib += 1
            continue
        if ca == "^" or cb == "^":
            if not ca:
                return -1
            if not cb:
                return 1
            if ca != "^":
                return 1
            if cb != "^":
                return -1
            ia += 1
            ib += 1
            continue
        # skip non-alphanumeric separators
        while ia < len(a) and not a[ia].isalnum() and a[ia] not in "~^":
            ia += 1
        while ib < len(b) and not b[ib].isalnum() and b[ib] not in "~^":
            ib += 1
        if ia >= len(a) or ib >= len(b):
            if ia < len(a):
                return 1
            if ib < len(b):
                return -1
            return 0
        if a[ia].isdigit() or b[ib].isdigit():
            ja, jb = ia, ib
            while ja < len(a) and a[ja].isdigit():
                ja += 1
            while jb < len(b) and b[jb].isdigit():
                jb += 1
            da, db_ = a[ia:ja], b[ib:jb]
            if not da:
                return -1  # alpha sorts before digits
            if not db_:
                return 1
            if int(da) != int(db_):
                return 1 if int(da) > int(db_) else -1
            ia, ib = ja, jb
        else:
            ja, jb = ia, ib
            while ja < len(a) and a[ja].isalpha():
                ja += 1
            while jb < len(b) and b[jb].isalpha():
                jb += 1
            sa, sb = a[ia:ja], b[ib:jb]
            if sa != sb:
                return 1 if sa > sb else -1
            ia, ib = ja, jb
    return 0


def _rpm_split(v: str) -> tuple[int, str, str]:
    epoch = 0
    if ":" in v:
        e, _, v = v.partition(":")
        try:
            epoch = int(e)
        except ValueError:
            pass
    ver, _, rel = v.partition("-")
    return epoch, ver, rel


def compare_rpm(a: str, b: str) -> int:
    """Full [epoch:]version[-release] comparison (rpm.go / go-rpm-version)."""
    ea, va, ra = _rpm_split(a)
    eb, vb, rb = _rpm_split(b)
    if ea != eb:
        return 1 if ea > eb else -1
    c = _rpm_seg_cmp(va, vb)
    if c != 0:
        return c
    return _rpm_seg_cmp(ra, rb)


_MAVEN_QUALIFIERS = {
    "alpha": 1, "a": 1, "beta": 2, "b": 2, "milestone": 3, "m": 3,
    "rc": 4, "cr": 4, "snapshot": 5, "": 6, "ga": 6, "final": 6,
    "release": 6, "sp": 7,
}


def _maven_tokens(v: str):
    """org.apache.maven.artifact.versioning.ComparableVersion, abridged:
    dot/dash-separated runs, numbers compare numerically, known qualifiers
    by rank (alpha < beta < milestone < rc < snapshot < release < sp),
    unknown qualifiers lexically after release."""
    for raw in re.split(r"[.\-_]", v.lower()):
        # ComparableVersion splits letter-digit transitions: rc1 -> rc, 1
        for tok in re.findall(r"\d+|[a-z]+", raw):
            if tok.isdigit():
                yield (1, int(tok), "")
            else:
                rank = _MAVEN_QUALIFIERS.get(tok)
                if rank is None:
                    yield (2, 8, tok)
                else:
                    yield (2, rank, "")


def compare_maven(a: str, b: str) -> int:
    ta, tb = list(_maven_tokens(a)), list(_maven_tokens(b))
    # trailing zeros / release qualifiers are neutral padding
    pad = (2, 6, "")
    n = max(len(ta), len(tb))
    for i in range(n):
        xa = ta[i] if i < len(ta) else ((1, 0, "") if (i < len(tb) and tb[i][0] == 1) else pad)
        xb = tb[i] if i < len(tb) else ((1, 0, "") if ta[i][0] == 1 else pad)
        if xa != xb:
            # numeric vs qualifier: numeric sorts after release qualifier
            if xa[0] != xb[0]:
                if xa[0] == 1:  # a numeric vs b qualifier
                    return 1 if xb[1] <= 6 or xa[1] > 0 else -1
                return -1 if xa[1] <= 6 or xb[1] > 0 else 1
            return 1 if xa > xb else -1
    return 0


COMPARATORS = {
    "apk": compare_apk,
    "deb": compare_deb,
    "rpm": compare_rpm,
    "maven": compare_maven,
    "semver": compare_semver,
    "pep440": compare_pep440,
    "generic": compare_generic,
}


# ---------------------------------------------------------------------------
# Range expressions ("<1.2.3", ">=4.0.0, <4.0.14", "a || b")
# ---------------------------------------------------------------------------

_OP = re.compile(r"^(>=|<=|>|<|=|==|!=|\^|~)?\s*(.+)$")


def _check_one(cmp, installed: str, constraint: str) -> bool:
    m = _OP.match(constraint.strip())
    if not m:
        return False
    op, ver = m.group(1) or "=", m.group(2).strip()
    if op == "^":
        # ^X.Y.Z pins the leftmost non-zero component (npm caret semantics):
        # ^1.2.3 => <2.0.0, ^0.2.3 => <0.3.0, ^0.0.3 => <0.0.4.  Partial
        # versions pin at the last specified component when all are zero:
        # ^0 => <1.0.0, ^0.0 => <0.1.0 (node-semver partial-caret rules).
        base = _semver_key(ver)[0]
        inst = _semver_key(installed)[0]
        core = re.split(r"[-+]", ver, maxsplit=1)[0]
        ncomp = min(3, len([c for c in core.split(".") if c not in ("", "x", "X", "*")]))
        ncomp = max(1, ncomp)
        pin = ncomp
        for i in range(ncomp):
            if base[i] != 0:
                pin = i + 1
                break
        return cmp(installed, ver) >= 0 and inst[:pin] == base[:pin]
    if op == "~":
        base = _semver_key(ver)[0]
        inst = _semver_key(installed)[0]
        return cmp(installed, ver) >= 0 and inst[:2] == base[:2]
    c = cmp(installed, ver)
    return {
        ">=": c >= 0,
        "<=": c <= 0,
        ">": c > 0,
        "<": c < 0,
        "=": c == 0,
        "==": c == 0,
        "!=": c != 0,
    }[op]


_CONSTRAINT = re.compile(r"\s*(>=|<=|==|!=|>|<|=|\^|~)?\s*([^\s,]+)")


def version_in_range(installed: str, expr: str, flavor: str = "semver") -> bool:
    """True when `installed` satisfies the vulnerable-range expression.

    Handles both packed (">=4.0.0,<4.0.14") and spaced (">= 4.0.0, < 4.0.14",
    the GHSA style) constraint forms."""
    cmp = COMPARATORS.get(flavor, compare_semver)
    for alternative in expr.split("||"):
        constraints = [
            f"{op or '='}{ver}"
            for op, ver in _CONSTRAINT.findall(alternative)
        ]
        if constraints and all(
            _check_one(cmp, installed, c) for c in constraints
        ):
            return True
    return False
