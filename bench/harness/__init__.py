"""The benchmark's driving code: the only part of `bench/` that imports
the program (`repro_torch`)."""
