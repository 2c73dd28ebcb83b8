"""Runs of the PyTorch port over several processes and hosts (see the
package docstring)."""
