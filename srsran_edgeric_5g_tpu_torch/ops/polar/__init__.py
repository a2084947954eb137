"""Polar code chain (TS 38.212 §5.3.1, §5.4.1): code construction,
encoding as GF(2) products, rate matching and dematching, the SC decoder
that PDCCH and PBCH receive use, and the CA-SCL list decoder that UCI
uses."""

from . import code, decoder, encoder, list_decoder, rate_match  # noqa: F401
