"""idle_wrappers.gram: the device's idle share under the kernel wrappers
and host reads, in the Gram cells; read as ``idle_wrappers.train`` is."""
SAME_AS = "idle_wrappers.train"
