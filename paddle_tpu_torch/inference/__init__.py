"""Serving runtime of the port: paged KV allocator, admission policy and
the continuous-batching engine."""
