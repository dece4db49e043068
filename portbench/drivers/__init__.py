"""Drivers: the general generators of work that a traffic file names by
its `driver` key. Each builds the program's entry point from the
configuration, feeds it from the seed, and checks what it produced
against the plain reference."""
