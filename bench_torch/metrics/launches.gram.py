"""launches.gram: the program's kernel launches a call, in the Gram cells;
read as ``launches.train`` is."""
SAME_AS = "launches.train"
