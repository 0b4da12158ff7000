"""Content addressing of rule material: the canonical ruleset digest."""
