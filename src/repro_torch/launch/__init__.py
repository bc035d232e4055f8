"""Command-line launchers (the reference's ``repro/launch``)."""
