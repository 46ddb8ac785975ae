// Native COCO-style detection matching kernels: the entries of
// native/coco_eval.cc, copied unchanged (ctypes-bound from
// agenda_tpu_torch/detect/native.py, built at first use by
// agenda_tpu_torch/utils/host_build.py).
//
// The evaluation hot loops (greedy IoU matching across 10 IoU thresholds for
// tens of thousands of images in the pseudo-label pipeline) are host-side
// and O(T * D * G) per image. Results are bit-identical to the port's numpy
// matchers (detect/coco_eval.py, annotate/threshold.py), the plain versions
// the tests hold this library to.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

inline double iou_xyxy(const double* a, const double* b) {
  const double xa = std::max(a[0], b[0]);
  const double ya = std::max(a[1], b[1]);
  const double xb = std::min(a[2], b[2]);
  const double yb = std::min(a[3], b[3]);
  const double iw = xb - xa;
  const double ih = yb - ya;
  const double inter = (iw > 0 && ih > 0) ? iw * ih : 0.0;
  const double area_a = (a[2] - a[0]) * (a[3] - a[1]);
  const double area_b = (b[2] - b[0]) * (b[3] - b[1]);
  const double uni = area_a + area_b - inter;
  return uni > 0 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// Greedy best-IoU matching for one image (COCOeval evaluateImg semantics).
//
// dets (D,4 xyxy) must already be sorted by descending score and truncated to
// max_dets by the caller. For each IoU threshold t: walk detections in order,
// match each to the unused GT with the highest IoU >= t.
// Output tp: T x D row-major bytes (1 = matched).
void match_image_greedy(const double* dets, int64_t n_det,
                        const double* gts, int64_t n_gt,
                        const double* iou_thrs, int64_t n_thr,
                        uint8_t* tp_out) {
  std::fill(tp_out, tp_out + n_thr * n_det, 0);
  if (n_det == 0 || n_gt == 0) return;

  // Precompute the D x G IoU matrix once.
  std::vector<double> ious(static_cast<size_t>(n_det) * n_gt);
  for (int64_t d = 0; d < n_det; ++d)
    for (int64_t g = 0; g < n_gt; ++g)
      ious[d * n_gt + g] = iou_xyxy(dets + 4 * d, gts + 4 * g);

  std::vector<uint8_t> used(n_gt);
  for (int64_t t = 0; t < n_thr; ++t) {
    std::fill(used.begin(), used.end(), 0);
    const double thr = iou_thrs[t];
    for (int64_t d = 0; d < n_det; ++d) {
      double best = thr;
      int64_t best_g = -1;
      for (int64_t g = 0; g < n_gt; ++g) {
        if (used[g]) continue;
        const double v = ious[d * n_gt + g];
        if (v >= best) {
          best = v;
          best_g = g;
        }
      }
      if (best_g >= 0) {
        used[best_g] = 1;
        tp_out[t * n_det + d] = 1;
      }
    }
  }
}

// First-match greedy matching in given order (EvaluatePseudoAnn /
// threshold-selection semantics): each pred matches the first unused GT with
// IoU >= thr. Boxes xyxy. Output: is_tp (D) bytes. Returns TP count.
int64_t match_first_greedy(const double* preds, int64_t n_pred,
                           const double* gts, int64_t n_gt,
                           double iou_thr, uint8_t* is_tp_out) {
  std::fill(is_tp_out, is_tp_out + n_pred, 0);
  std::vector<uint8_t> used(n_gt, 0);
  int64_t tp = 0;
  for (int64_t p = 0; p < n_pred; ++p) {
    for (int64_t g = 0; g < n_gt; ++g) {
      if (used[g]) continue;
      if (iou_xyxy(preds + 4 * p, gts + 4 * g) >= iou_thr) {
        used[g] = 1;
        is_tp_out[p] = 1;
        ++tp;
        break;
      }
    }
  }
  return tp;
}

// Best-candidate greedy matching per GT (threshold.py match_predictions
// semantics): walk GTs in order, each grabs the highest-scoring unmatched
// prediction with IoU >= thr (preds pre-sorted by score descending).
void match_per_gt_greedy(const double* preds, int64_t n_pred,
                         const double* gts, int64_t n_gt,
                         double iou_thr, uint8_t* is_tp_out) {
  std::fill(is_tp_out, is_tp_out + n_pred, 0);
  for (int64_t g = 0; g < n_gt; ++g) {
    for (int64_t p = 0; p < n_pred; ++p) {
      if (is_tp_out[p]) continue;
      if (iou_xyxy(preds + 4 * p, gts + 4 * g) >= iou_thr) {
        is_tp_out[p] = 1;
        break;
      }
    }
  }
}

// Greedy NMS on score-sorted boxes (host-side post-processing fallback).
// boxes (N,4 xyxy) sorted by descending score. keep_out: N bytes.
int64_t nms_sorted(const double* boxes, int64_t n, double iou_thr,
                   int64_t max_keep, uint8_t* keep_out) {
  std::fill(keep_out, keep_out + n, 0);
  int64_t kept = 0;
  for (int64_t i = 0; i < n && kept < max_keep; ++i) {
    bool ok = true;
    for (int64_t j = 0; j < i; ++j) {
      if (!keep_out[j]) continue;
      if (iou_xyxy(boxes + 4 * i, boxes + 4 * j) > iou_thr) {
        ok = false;
        break;
      }
    }
    if (ok) {
      keep_out[i] = 1;
      ++kept;
    }
  }
  return kept;
}

}  // extern "C"
