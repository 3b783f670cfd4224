"""Frozen work counts: the operations and bytes that the benchmark's
inputs need, computed from the configuration's shapes alone, whatever
implements them."""
