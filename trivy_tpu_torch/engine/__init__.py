"""Secret-scan engine: regex translation, probe/gram compilation, oracle, codec, device engine."""
