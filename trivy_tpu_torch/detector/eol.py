"""Per-distro end-of-life tables (pkg/detector/ospkg/*/: eolDates maps).

Dates are the distros' published EOL dates, as carried by the reference's
per-driver tables (e.g. alpine.go:21, debian.go, ubuntu.go).  Versions not
listed warn "not on the EOL list" and are treated as supported (they may be
newer than this table), mirroring osver.Supported
(pkg/detector/ospkg/version/version.go).

Copied from `trivy_tpu/detector/eol.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import datetime as _dt
import logging

logger = logging.getLogger(__name__)


def _d(y: int, m: int, day: int) -> _dt.datetime:
    return _dt.datetime(y, m, day, tzinfo=_dt.timezone.utc)


# family -> version (at the driver's release precision) -> EOL date
EOL_DATES: dict[str, dict[str, _dt.datetime]] = {
    "alpine": {
        "2.7": _d(2015, 11, 1), "3.0": _d(2016, 5, 1), "3.1": _d(2016, 11, 1),
        "3.2": _d(2017, 5, 1), "3.3": _d(2017, 11, 1), "3.4": _d(2018, 5, 1),
        "3.5": _d(2018, 11, 1), "3.6": _d(2019, 5, 1), "3.7": _d(2019, 11, 1),
        "3.8": _d(2020, 5, 1), "3.9": _d(2020, 11, 1), "3.10": _d(2021, 5, 1),
        "3.11": _d(2021, 11, 1), "3.12": _d(2022, 5, 1), "3.13": _d(2022, 11, 1),
        "3.14": _d(2023, 5, 1), "3.15": _d(2023, 11, 1), "3.16": _d(2024, 5, 23),
        "3.17": _d(2024, 11, 22), "3.18": _d(2025, 5, 9),
        "3.19": _d(2025, 11, 1), "3.20": _d(2026, 4, 1), "3.21": _d(2026, 11, 1),
    },
    "debian": {
        "7": _d(2018, 5, 31), "8": _d(2020, 6, 30), "9": _d(2022, 6, 30),
        "10": _d(2024, 6, 30), "11": _d(2026, 8, 31), "12": _d(2028, 6, 30),
    },
    "ubuntu": {
        "14.04": _d(2024, 4, 25), "16.04": _d(2026, 4, 23),
        "18.04": _d(2028, 4, 26), "20.04": _d(2030, 4, 23),
        "21.10": _d(2022, 7, 14), "22.04": _d(2032, 4, 21),
        "22.10": _d(2023, 7, 20), "23.04": _d(2024, 1, 25),
        "23.10": _d(2024, 7, 11), "24.04": _d(2034, 4, 25),
    },
    "centos": {
        "6": _d(2020, 11, 30), "7": _d(2024, 6, 30), "8": _d(2021, 12, 31),
    },
    "redhat": {
        "6": _d(2024, 6, 30), "7": _d(2024, 6, 30), "8": _d(2029, 5, 31),
        "9": _d(2032, 5, 31),
    },
    "amazon": {
        "1": _d(2023, 12, 31), "2": _d(2026, 6, 30), "2022": _d(2026, 6, 30),
        "2023": _d(2028, 3, 15),
    },
    "suse linux enterprise server": {
        "12.5": _d(2024, 10, 31), "15": _d(2019, 12, 31),
        "15.1": _d(2021, 1, 31), "15.2": _d(2021, 12, 31),
        "15.3": _d(2022, 12, 31), "15.4": _d(2023, 12, 31),
        "15.5": _d(2028, 12, 31),
    },
    "opensuse-leap": {
        "15.0": _d(2019, 12, 3), "15.1": _d(2020, 11, 30),
        "15.2": _d(2021, 11, 30), "15.3": _d(2022, 11, 30),
        "15.4": _d(2023, 11, 30), "15.5": _d(2024, 12, 31),
    },
    "fedora": {
        "37": _d(2023, 12, 5), "38": _d(2024, 5, 21), "39": _d(2024, 11, 26),
        "40": _d(2025, 5, 28), "41": _d(2025, 12, 2),
    },
}


def is_supported_version(
    family: str, release: str, now: _dt.datetime | None = None
) -> bool:
    """osver.Supported (version.go): warn + continue for unknown versions,
    warn loudly for EOL ones.  Detection always proceeds either way — the
    reference only logs."""
    if now is None:
        now = _dt.datetime.now(_dt.timezone.utc)
    table = EOL_DATES.get(family)
    if table is None:
        return True
    eol = table.get(release)
    if eol is None:
        logger.warning(
            "This OS version is not on the EOL list: %s %s", family, release
        )
        return True  # can be the latest version
    if now >= eol:
        logger.warning(
            "This OS version is no longer supported by the distribution: "
            "%s %s (EOL %s); the vulnerability results may be incomplete",
            family, release, eol.date(),
        )
        return False
    return True
