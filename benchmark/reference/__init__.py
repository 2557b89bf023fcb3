"""Plain references the benchmark holds the program to, one module per
configuration's ``reference``."""
