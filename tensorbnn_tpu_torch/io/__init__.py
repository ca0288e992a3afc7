"""Sample stores: the reference text format, the npz store and the resume
checkpoint, with the native text parser."""
