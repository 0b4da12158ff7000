"""Secret rule model and the builtin ruleset (copies of trivy_tpu.rules)."""
