// K9 and K10 with the epilogue alone compiled in (kPhaseEpilogue), to time
// where a launch's time goes (kernels/quant.py `_qconv_ablate` and
// `_qdense_ablate`; chip_smoke.py's [k9-split] and [k10-split] lines).
// Their outputs are meaningless.  One file a phase, so that nvcc builds
// the variants side by side.

#include "qdense.cuh"
#include "qgemm.cuh"

extern "C" int ipe_qconv_epilogue_only(const QconvArgs* a) { return qconv_run<qg::kPhaseEpilogue>(a); }
extern "C" int ipe_qdense_epilogue_only(const QdenseArgs* a) { return qdense_run<qg::kPhaseEpilogue>(a); }
