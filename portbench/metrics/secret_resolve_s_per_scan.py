"""Seconds of the secret program's resolve per scan in the multi-program pass
(`GpuSecretEngine.confirm`, the exact confirm over each file's candidate
rules and the allow-path shape; the `programs.resolve` span with `program`
`secret`): `SieveStats.secret_resolve_s`."""

from portbench.metrics._stage import per_scan


def read(run):
    return per_scan(run, "secret_resolve_s")
