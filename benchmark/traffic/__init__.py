"""Traffic generators, one module per kind; a cell file names its kind
and gives its parameters."""
