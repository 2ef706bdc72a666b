"""idle.gram: the share of the traced window in which no operation ran on
the device, in the Gram cells, in %; read as ``idle.train`` is."""
SAME_AS = "idle.train"
