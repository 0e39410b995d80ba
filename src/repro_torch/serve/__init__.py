"""Serving (port of ``repro.serve``): the wave engine behind the bulk-steal
admission master."""
