"""idle_estimators.gram: the device's idle share in the estimators' own
code, in the Gram cells; read as ``idle_estimators.train`` is."""
SAME_AS = "idle_estimators.train"
