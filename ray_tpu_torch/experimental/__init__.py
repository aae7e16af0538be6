"""Experimental APIs of the port: shared-memory channels (`channel`) and
the internal KV (`internal_kv`)."""
