"""Framework pieces of the port: the Program IR, scope, places, dtypes,
unique names and the rewrite passes."""
