"""Columnar tables (the port's copy of ``repro.data.tables``)."""
