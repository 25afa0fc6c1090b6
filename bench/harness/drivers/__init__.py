"""The drivers of the traffic kinds: `traffic/<mix>.json` names its driver,
and `drivers/<driver>.py` gives `run` (one run of a cell) and
`calibration` (the readings of its control and planted faults)."""
