"""syncs.gram: the program's host reads of device values a call, in the
Gram cells; read as ``syncs.train`` is."""
SAME_AS = "syncs.train"
