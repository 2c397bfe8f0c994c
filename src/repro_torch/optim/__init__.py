"""The optimizer of the port's train step: AdamW over a name -> tensor dict."""
