"""call_roofline.gram: the least time of the window's calls' mathematics
over the device's busy time, in the Gram cells, in %; read as
``call_roofline.train`` is."""
SAME_AS = "call_roofline.train"
