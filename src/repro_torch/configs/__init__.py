"""Model configurations the port runs (copies of src/repro/configs/)."""
