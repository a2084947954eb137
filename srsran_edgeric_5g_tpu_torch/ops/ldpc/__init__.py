"""NR LDPC codec: segmentation, encoding, rate matching and decoding."""
