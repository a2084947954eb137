"""Work, bytes and peaks of the kernels whose roofline shares the
benchmark reports, counted from shapes and from what the inputs need."""
