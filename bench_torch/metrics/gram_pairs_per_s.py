"""gram_pairs_per_s: path-pairs whose kernel value the window's calls
computed, over the window's seconds (host clock); read as
``train_pairs_per_s`` is."""
SAME_AS = "train_pairs_per_s"
