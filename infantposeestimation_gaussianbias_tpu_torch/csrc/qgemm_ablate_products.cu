// K9 and K10 with the products alone compiled in (kPhaseProduct), to time
// where a launch's time goes (kernels/quant.py `_qconv_ablate` and
// `_qdense_ablate`; chip_smoke.py's [k9-split] and [k10-split] lines).
// Their outputs are meaningless.  One file a phase, so that nvcc builds
// the variants side by side.

#include "qdense.cuh"
#include "qgemm.cuh"

extern "C" int ipe_qconv_products_only(const QconvArgs* a) { return qconv_run<qg::kPhaseProduct>(a); }
extern "C" int ipe_qdense_products_only(const QdenseArgs* a) { return qdense_run<qg::kPhaseProduct>(a); }
