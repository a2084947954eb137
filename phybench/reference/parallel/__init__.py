"""The full gNB slot and its data plane, on one device."""
