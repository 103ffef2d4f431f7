"""Host IO of the port: Matrix Market input (a native C parser with a
pure-Python fallback), eigenvector-selection files and result files, in the
reference's formats.  numpy and the standard library only; nothing here
touches a device."""
