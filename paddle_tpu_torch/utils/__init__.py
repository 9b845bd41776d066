"""Utilities of the port: flags, and the fusion-chain finder."""
