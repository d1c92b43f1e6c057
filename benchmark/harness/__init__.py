"""The benchmark's own code: cells by name, the sample generator, the
window's samplers, the reading of the device trace, the roofline counts
and the check that decides `correct`. Nothing here is the program's."""
