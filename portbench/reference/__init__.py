"""Plain references of what the benchmark's cells compute. Nothing here
imports the program: each module is written from the published definitions
and reads only the inputs and weights that the benchmark makes."""
