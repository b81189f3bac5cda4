"""Plain PyTorch references of what the benchmark's cells compute: CSM
(:mod:`.csm`) and the Mimi decoder (:mod:`.mimi`).  They import nothing of
the program and take nothing it made: the benchmark hands them the weights
and inputs it made itself, and the program's outputs only to be judged."""
