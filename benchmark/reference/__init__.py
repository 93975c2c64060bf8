"""The plain reference: frozen copies of KWAGE's k-mer, hash and threshold
rules and a plain PyTorch search. Nothing here imports the program under
test."""
