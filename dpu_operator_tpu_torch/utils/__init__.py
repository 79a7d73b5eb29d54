"""Framework-neutral helpers of the port (its own copies, under the
isolation rule)."""
