"""A fixture for the port's tests that compare the two CLIs' stderr byte for
byte: both packages' console log formatter stamps each line with the wall
clock to the second (`log.py` `ConsoleFormatter`, through
`logging.Formatter.converter`), so a port run and a reference run that fall
on two sides of a second boundary print different lines for the same log
record.  The fixture pins the formatters' clock to one instant for the
test; everything else on the lines is compared as it is printed.

Import it by name into a test module (`from torch_log_clock import
frozen_log_clock  # noqa: F401`); it is autouse there.
"""

import logging
import time

import pytest

FROZEN = time.gmtime(1_700_000_000)


@pytest.fixture(autouse=True)
def frozen_log_clock(monkeypatch):
    monkeypatch.setattr(logging.Formatter, "converter", staticmethod(lambda secs=None: FROZEN))
