"""Host-side packing (a copy of trivy_tpu.scanner.packing)."""
