"""Polar code chain (TS 38.212 §5.3.1, §5.4.1): code construction,
encoding as GF(2) products and rate matching, as the PDCCH and PBCH
transmitters use them."""

from . import code, encoder, rate_match  # noqa: F401
