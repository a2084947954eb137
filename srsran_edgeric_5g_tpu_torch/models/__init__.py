"""Signal-chain models built from the ops: control-channel transmitters."""
