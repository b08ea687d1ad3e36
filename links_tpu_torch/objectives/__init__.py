"""The stages' objectives and the eval forwards of the serving lift."""
