"""The benchmark's own library: loading cells by name, traffic, weights,
the trace's reduction, roofline arithmetic and the comparison that
decides `correct`. It imports nothing of the program at module level."""
