"""RAN parameter math (numerology, TBS) — host-side Python."""
