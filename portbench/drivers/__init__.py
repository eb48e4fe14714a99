"""One module for each kind of traffic; a mix's file under traffic/ names
its driver and holds the parameters the driver reads."""
