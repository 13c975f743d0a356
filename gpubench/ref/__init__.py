"""The plain reference: NumPy (and plain PyTorch for the genome's
sketch) copies of minimap2 v2.18's seeding, chaining and extension
semantics, frozen here so that later changes to the program cannot move
the yardstick. Imports nothing of the program."""
