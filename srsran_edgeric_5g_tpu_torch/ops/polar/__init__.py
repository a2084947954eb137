"""Polar code chain for PDCCH / PBCH (TS 38.212 §5.3.1, §5.4.1): code
construction, encoding as GF(2) products, rate matching."""

from . import code, encoder, rate_match  # noqa: F401
