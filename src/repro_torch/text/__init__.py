"""Text tooling of the port (numpy over the device index): the LCP array
(`lcp`), exact-substring dedup (`dedup`) and the deprecated `CorpusSA`
shim (`corpus_sa`). Like `repro.text`, the package exports nothing of its
own: `repro_torch.api.index` imports `lcp`, and `dedup` / `corpus_sa`
import `repro_torch.api`, so import the modules by name."""
